"""The one traffic generator: a cell's workload file in, transactions out.

It reads the ``population`` and ``arrivals`` parameters of
``perfbench/workloads/<cell>.json`` and draws everything from ``--seed``
through the frozen copies in ``perfbench/frozen/`` (the simulator's user and
merchant pools and its transaction records; the arrival intensity of
``sim/arrivals.py``):

- ``{"kind": "backlog", "depth_per_s": D}``: ``D x seconds`` transactions,
  all in the topic before the window opens;
- ``{"kind": "poisson", "rate_per_s": R}``: open-loop arrivals from
  independent cardholders at R a second;
- ``{"kind": "diurnal", ...}``: the arrival process of ``sim/arrivals.py``
  (``DiurnalBurstConfig``'s fields).

Open-loop arrivals are the process conditioned on its expected count: the
same number of transactions for every seed, spread over the window with
density proportional to the intensity, so a seed changes which work arrives
when and never how much.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import numpy as np

from perfbench.frozen.arrivals import DiurnalBurstConfig, DiurnalBurstProcess
from perfbench.frozen.simulator import TransactionGenerator


@dataclasses.dataclass
class Traffic:
    users: Dict[str, Dict[str, Any]]        # user_id -> profile
    merchants: Dict[str, Dict[str, Any]]    # merchant_id -> profile
    warmup: List[Dict[str, Any]]            # records scored during set-up
    records: List[Dict[str, Any]]           # the window's records
    due: np.ndarray                         # f64 seconds after the window opens
    open_loop: bool


def _intensity(arrivals: Dict[str, Any]) -> DiurnalBurstConfig:
    if arrivals["kind"] == "poisson":
        rate = float(arrivals["rate_per_s"])
        return DiurnalBurstConfig(trough_tps=rate, peak_tps=rate,
                                  burst_duration_s=0.0, burst_mult=1.0)
    fields = {f.name for f in dataclasses.fields(DiurnalBurstConfig)}
    return DiurnalBurstConfig(**{k: v for k, v in arrivals.items() if k in fields})


def arrival_times(arrivals: Dict[str, Any], seconds: float,
                  seed: int) -> np.ndarray:
    """Sorted due times in [0, seconds) for an open-loop mix."""
    proc = DiurnalBurstProcess(_intensity(arrivals), seed=0)
    grid = np.linspace(0.0, seconds, 4097)
    mean_rate = float(np.mean(proc._rates(grid)))
    n = int(round(mean_rate * seconds))
    rng = np.random.default_rng([int(seed) & 0xFFFF_FFFF_FFFF_FFFF, 1])
    peak = proc.peak_rate()
    out: List[np.ndarray] = []
    have = 0
    while have < n:
        cand = rng.uniform(0.0, seconds, 2 * (n - have) + 16)
        keep = cand[rng.uniform(0.0, peak, cand.size) < proc._rates(cand)]
        out.append(keep[:n - have])
        have += out[-1].size
    return np.sort(np.concatenate(out)) if out else np.zeros((0,))


def make_traffic(cell: Dict[str, Any], seed: int, seconds: float,
                 warmup_rows: int) -> Traffic:
    pop = cell["population"]
    gen = TransactionGenerator(num_users=int(pop["users"]),
                               num_merchants=int(pop["merchants"]),
                               seed=int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    users, merchants = gen.users.profiles(), gen.merchants.profiles()
    warmup = gen.generate_batch(warmup_rows)
    arrivals = cell["arrivals"]
    if arrivals["kind"] == "backlog":
        n = int(math.ceil(float(arrivals["depth_per_s"]) * seconds))
        due = np.zeros((n,))
        open_loop = False
    else:
        due = arrival_times(arrivals, seconds, seed)
        open_loop = True
    records = gen.generate_batch(len(due))
    return Traffic(users, merchants, warmup, records, due, open_loop)
