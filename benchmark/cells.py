"""A cell's files, found by the names `BENCHMARK.json` gives: its
configuration, its traffic mix, its per-layer metric readers."""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict) -> dict:
    """{"workload", "config", "traffic", "end_to_end", "per_layer"} of cell
    `name`: its configuration and traffic files read, and the metrics it
    reports (those without a `workloads` list, or whose list names it)."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(wl)}")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"workload": w,
            "config": json.loads((ROOT / cfg_entry["file"]).read_text()),
            "traffic": json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def reader(metric: str):
    """The `read(record)` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def pose(traffic: dict, seed: int, k: int) -> dict:
    """Frame k's pose on the cell's camera path: the yaw swings by
    `yaw_amplitude` about `yaw` with a period of `period` frames, its phase
    set by the seed. Pose k and pose k + period are the same pose."""
    p = traffic["period"]
    q = (k + seed) % p
    return {"position": traffic["position"], "pitch": traffic["pitch"], "index": q,
            "yaw": traffic["yaw"] + traffic["yaw_amplitude"] * math.sin(2.0 * math.pi * q / p)}
