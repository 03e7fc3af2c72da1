"""Closed-loop HTTP load against a running scoring service.

``run_load`` sends each transaction once as ``POST /predict`` from
``clients`` threads, each on its own keep-alive connection, one request in
flight per client. A 503 (admission shed at the door) is counted and the
request retried after ``retry_s``, so every transaction is answered once.
Each answer is recorded with its status, its start and end on
``time.monotonic`` (one clock for every process of the host, so a caller in
another process can line its own events up with them) and its body. Only
the standard library is imported, so a measuring process can run it apart
from the server it measures:

    python -m realtime_fraud_detection_tpu_torch.serving.loadgen \\
        --port 8080 --clients 64 --txns txns.json --out answers.json \\
        [--progress-at 512]

reads a JSON list of transactions and writes ``{"answers": [...],
"shed_503": n, "wall_s": s}``; with ``--progress-at K`` it prints
``progress`` on its own line (flushed) once K answers are in.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

__all__ = ["run_load"]


def run_load(host: str, port: int, txns: Sequence[Mapping[str, Any]],
             clients: int = 64, retry_s: float = 0.001, timeout_s: float = 60.0,
             progress_at: Optional[int] = None,
             on_progress: Optional[Callable[[], None]] = None) -> Dict[str, Any]:
    """Answers in the order they came in, the 503s retried, the wall time."""
    lock = threading.Lock()
    next_i = [0]
    answers: List[Dict[str, Any]] = []
    shed = [0]
    errors: List[str] = []

    def client() -> None:
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        try:
            while True:
                with lock:
                    i = next_i[0]
                    next_i[0] += 1
                if i >= len(txns):
                    return
                payload = json.dumps(txns[i])
                while True:
                    # rtfd-lint: allow[wall-clock] HTTP load client: a request's latency is measured on the wall clock by definition
                    t0 = time.monotonic()
                    conn.request("POST", "/predict", body=payload,
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    raw = resp.read()
                    # rtfd-lint: allow[wall-clock] HTTP load client: a request's latency is measured on the wall clock by definition
                    t1 = time.monotonic()
                    if resp.status != 503:
                        break
                    with lock:
                        shed[0] += 1
                    time.sleep(retry_s)
                row = {"i": i, "status": resp.status, "t0": t0, "t1": t1,
                       "body": json.loads(raw)}
                with lock:
                    answers.append(row)
                    if progress_at is not None and len(answers) == progress_at \
                            and on_progress is not None:
                        on_progress()
        except (OSError, http.client.HTTPException, ValueError) as e:
            with lock:
                errors.append(f"{type(e).__name__}: {e}")
        finally:
            conn.close()

    # rtfd-lint: allow[wall-clock] HTTP load client: the run's wall time is reported, not a control input
    t_start = time.monotonic()
    threads = [threading.Thread(target=client, name=f"load-{k}", daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s * max(1, len(txns)))
    if any(t.is_alive() for t in threads):
        errors.append("a client thread did not finish")
    return {"answers": answers, "shed_503": shed[0], "errors": errors,
            # rtfd-lint: allow[wall-clock] HTTP load client: the run's wall time is reported, not a control input
            "wall_s": time.monotonic() - t_start}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="loadgen")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--clients", type=int, default=64)
    parser.add_argument("--txns", required=True, help="JSON list of transactions")
    parser.add_argument("--out", required=True, help="where the answers go (JSON)")
    parser.add_argument("--progress-at", type=int, default=None)
    args = parser.parse_args(argv)
    with open(args.txns) as f:
        txns = json.load(f)
    result = run_load(args.host, args.port, txns, clients=args.clients,
                      progress_at=args.progress_at,
                      on_progress=lambda: print("progress", flush=True))
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(json.dumps({"answers": len(result["answers"]), "shed_503": result["shed_503"],
                      "errors": result["errors"][:3], "wall_s": result["wall_s"]}),
          flush=True)
    return 0 if not result["errors"] and len(result["answers"]) == len(txns) else 1


if __name__ == "__main__":
    sys.exit(main())
