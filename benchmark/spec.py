"""What the benchmark holds, found by name: BENCHMARK.json at the root of
the checkout, and under this folder a configuration file, a cell (traffic)
file, a runner, a metric reader and a kernel family's files of their own.

Nothing here imports the program: the runner and the tests read the
files alone."""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """BENCHMARK.json."""
    return load_json(root / "BENCHMARK.json")


def cell(name: str, here: Path = HERE) -> dict:
    """A cell's file, ``workloads/<name>.json``, with its name."""
    path = here / "workloads" / f"{name}.json"
    if not NAME.match(name) or not path.is_file():
        raise SystemExit(f"no cell {name!r}: {path} is not a file")
    return {"name": name, **load_json(path)}


def cells(here: Path = HERE) -> List[str]:
    """The names of every cell file."""
    return sorted(p.stem for p in (here / "workloads").glob("*.json"))


def config(name: str, here: Path = HERE) -> dict:
    """A configuration's file, ``configs/<name>.json``."""
    return load_json(here / "configs" / f"{name}.json")


def runner(kind: str):
    """The runner module of a cell's kind, ``runners/<kind>.py``."""
    return importlib.import_module(f"benchmark.runners.{kind}")


def reader(metric: str):
    """A metric's reader, ``metrics/<metric>.py`` (dots in the name read
    as underscores in the file name: ``step_mfu.train`` ->
    ``metrics/step_mfu_train.py``)."""
    return importlib.import_module(
        "benchmark.metrics." + metric.replace(".", "_").replace("-", "_"))


def kernel_family(name: str, here: Path = HERE) -> dict:
    """A kernel family's profiler-name patterns, ``kernels/<name>.json``."""
    return load_json(here / "kernels" / f"{name}.json")


def metrics_of(bench: dict, cell_name: str, section: str) -> List[dict]:
    """The metrics of ``section`` ('end_to_end' or 'per_layer') that a cell
    reports: those that list it under ``workloads``, and those with no
    such list."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def problems(bench: dict, here: Path = HERE) -> List[str]:
    """What is wrong with BENCHMARK.json and the files it names (empty
    when nothing is)."""
    out = []
    names = set()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            n = entry["name"]
            if not NAME.match(n):
                out.append(f"{section}: bad name {n!r}")
            if n in names:
                out.append(f"{section}: {n!r} named twice")
            names.add(n)
            if "unit" in entry and not UNIT.match(entry["unit"]):
                out.append(f"{n}: bad unit {entry['unit']!r}")
    for c in bench["configs"]:
        if not (ROOT / c["file"]).is_file():
            out.append(f"{c['name']}: no file {c['file']}")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        if not (here / "workloads" / f"{w['name']}.json").is_file():
            out.append(f"{w['name']}: no cell file")
            continue
        spec = cell(w["name"], here)
        if spec["config"] != w["config"]:
            out.append(f"{w['name']}: config {spec['config']} in its file")
        if not (here / "runners" / f"{spec['runner']}.py").is_file():
            out.append(f"{w['name']}: no runner {spec['runner']}")
        mine = [m["name"] for m in metrics_of(bench, w["name"], "end_to_end")]
        if "setup_s" not in mine or len(mine) < 2:
            out.append(f"{w['name']}: needs setup_s and another end-to-end")
        layer = metrics_of(bench, w["name"], "per_layer")
        if not layer:
            out.append(f"{w['name']}: no per-layer metric")
        for m in layer:
            if m["moves"] not in mine:
                out.append(f"{m['name']} moves {m['moves']}, which "
                           f"{w['name']} does not report")
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = here / "metrics" / (m["name"].replace(".", "_")
                                  .replace("-", "_") + ".py")
        if not mod.is_file():
            out.append(f"{m['name']}: no reader {mod.name}")
        if m.get("moves") and m["moves"] not in e2e:
            out.append(f"{m['name']}: moves an unknown metric")
    return out
