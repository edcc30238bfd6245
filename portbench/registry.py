"""Discovery by name: the cell's entries in BENCHMARK.json, its
configuration and traffic files, and the readers of its per-layer
metrics."""
from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


def load_benchmark(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    """The workload entry `name`, with its configuration's entry."""
    for w in bench["workloads"]:
        if w["name"] == name:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return {**w, "config_entry": cfg}
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(root: pathlib.Path, entry: dict) -> dict:
    return json.loads((root / entry["file"]).read_text())


def load_traffic(name: str, base: pathlib.Path = HERE) -> dict:
    return json.loads((base / "traffic" / f"{name}.json").read_text())


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The cell's end_to_end or per_layer metrics: those without a
    `workloads` key and those that list it."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def load_reader(metric: str, base: pathlib.Path = HERE):
    """The reader module of a per-layer metric, layers/<metric>.py."""
    path = base / "layers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_layer_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
