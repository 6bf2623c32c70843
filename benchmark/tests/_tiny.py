"""A tiny copy of the benchmark for CPU tests: the benchmark folder and
BENCHMARK.json under a temporary root, beside a link to the port, with
every configuration and cell file cut to a few hundred voxels. Only data
files change: the harness's code is the one under test."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent
CELLS = ("gcl.train.b4x7", "fcgf.train.b4pairs", "gcl.register.sc2pcr",
         "fcgf.register.ransac")


def _edit(path: Path, fn) -> None:
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d, indent=1))


def _tiny_config(d: dict, float32: bool) -> None:
    tr = d["train"]
    tr["run_config"]["voxel_capacity"] = tr["step_config"]["nv_cap"] = 256
    tr["run_config"]["batch_size"] = 2
    for k in ("num_pos_per_batch", "num_hn_samples_per_batch"):
        tr["loss"][k] = tr["run_config"][k] = 16
    if tr["step"] == "colocation":
        tr["run_config"]["num_neighborhood"] = 2
    if float32:
        tr["run_config"]["compute_dtype"] = "float32"
        tr["step_config"]["compute_dtype"] = "float32"
    d["register"]["nv_cap"] = 256
    if "ransac" in d["register"]:
        d["register"]["ransac"].update(points=64, hypotheses=256)
    if "sc2pcr" in d["register"]:
        d["register"]["sc2pcr"].update(num_node=128, max_points=128)


def _tiny_cell(d: dict) -> None:
    d["traffic"].update(points=1024, pool=2)
    if "batch" in d["traffic"]:
        d["traffic"].update(batch=2)
    if "clouds" in d["traffic"]:
        d["traffic"].update(clouds=3)
    if "keypoints" in d.get("estimator", {}):
        d["estimator"]["keypoints"] = 64
    if "check_within" in d:
        d.update(check_within=2, check_pairs=2, warmup_pairs=1,
                 trace_units=1, span_units=1)


def make(root: Path, float32: bool = True) -> Path:
    """The tiny copy under ``root``; ``float32`` runs GCL training in
    float32, where the port's plain path and the reference agree bit for
    bit on the CPU."""
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "gcl_tpu_torch", root / "gcl_tpu_torch")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for p in (root / "benchmark" / "configs").glob("*.json"):
        _edit(p, lambda d: _tiny_config(d, float32))
    for p in (root / "benchmark" / "workloads").glob("*.json"):
        _edit(p, _tiny_cell)
    return root


def run_cell(root: Path, cell: str, seed: int = 5, seconds: float = 0.5,
             trace: int = 0, prelude: str = "", timeout: int = 600):
    """Run a cell of the tiny copy on the CPU in a process of its own,
    after ``prelude`` (Python that may break the program underneath).
    Returns (exit code, the result line as a dict or None, stderr)."""
    code = (f"import sys\nsys.path.insert(0, {str(root)!r})\n{prelude}\n"
            f"from benchmark import run\n"
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', "
            f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
            f"device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith(
        "{") else None
    return p.returncode, result, p.stderr
