"""Finding a cell, its configuration and its metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells and the metrics;
everything that belongs to one cell, one configuration or one per-layer
metric sits in a file of its own under ``perfbench/``:

- ``perfbench/workloads/<cell>.json``: the traffic and the job's settings;
- ``perfbench/configs/<config>.json``: the configuration's sizes;
- ``perfbench/metrics/<metric>.py``: the reader of one per-layer metric.

A later cell or metric is a new file and a new ``BENCHMARK.json`` entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def cell(name: str, bench: Dict[str, Any]) -> Dict[str, Any]:
    """The cell's ``BENCHMARK.json`` entry merged with its workload file."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if spec["config"] != entry["config"] or spec["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json")
    return {**spec, "name": name, "chips": int(entry["chips"])}


def config(name: str) -> Dict[str, Any]:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def metrics_for(cell_name: str, bench: Dict[str, Any], trace: bool
                ) -> List[Dict[str, Any]]:
    """The metrics a run of the cell reports: its end-to-end ones untraced,
    its per-layer ones traced. A metric without ``workloads`` belongs to
    every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str) -> Callable[[Any], Any]:
    """``perfbench/metrics/<metric>.py``'s ``read(ctx)``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
