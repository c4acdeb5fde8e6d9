"""`BENCHMARK.json` and the files its names resolve to.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name:

- a configuration: the JSON file its entry names (`file`), whose `schema`
  names the generator `portbench/gen/<schema>.py`;
- a traffic mix: `portbench/traffic/<traffic>.json`, whose `kind` names
  the loop that drives it, `portbench/kinds/<kind>.py`;
- a per-layer metric: `portbench/layer_metrics/<name>.py`, whose `read(ctx)`
  returns the metric's value, or None where the window has nothing to
  read.

So a new cell, mix or metric is new files and new entries, and no edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list           # the manifest's entries this cell reports
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: dict, cell: str, root: Path = ROOT,
            bench: Path = BENCH) -> Cell:
    """The cell's configuration, traffic mix and metrics, by name."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                       f"(has {sorted(work)})")
    w = work[cell]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(bench / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, cell)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in moved and _reports(m, cell)]
    return Cell(cell, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, e2e, per_layer)


def generator(schema: str):
    return importlib.import_module(f"portbench.gen.{schema}")


def kind(name: str):
    return importlib.import_module(f"portbench.kinds.{name}")


def reader(metric: str, bench: Path = BENCH):
    """The `read(ctx)` of one per-layer metric, loaded from its file (a
    metric's name may hold dots, so it is loaded by path)."""
    path = bench / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
