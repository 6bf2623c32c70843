"""gcl_tpu_torch stands alone: it imports on a CPU-only machine without JAX,
flax, optax, gcl_tpu, scikit-learn or matplotlib (the card's machine has
neither of the last two), and importing it builds no kernel and no host
library; chip_smoke.py imports none of them either; the port's bench runs
on the CPU when asked."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

_PROBE = """
import importlib, pkgutil, sys
import gcl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gcl_tpu_torch.__path__,
                                                "gcl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from gcl_tpu_torch.kernels import build
from gcl_tpu_torch import native
from gcl_tpu_torch.data.kitti_io import prefetch_scans, read_velodyne_bin
from gcl_tpu_torch.data.synthetic import generate_synthetic_nuscenes
from gcl_tpu_torch.reg.se3 import concatenate, decompose_trans
from gcl_tpu_torch.utils.timer import MinTimer
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "gcl_tpu", "sklearn", "matplotlib"))
missing = [n for n in ("gcl_tpu_torch.losses.gcl", "gcl_tpu_torch.train.steps",
                       "gcl_tpu_torch.bench",
                       "gcl_tpu_torch.kernels.scalar_conv",
                       "gcl_tpu_torch.kernels.radius_topk",
                       "gcl_tpu_torch.train.diagnostics",
                       "gcl_tpu_torch.eval_kitti",
                       "gcl_tpu_torch.train.checkpoint",
                       "gcl_tpu_torch.losses.pairs",
                       "gcl_tpu_torch.data.colocation",
                       "gcl_tpu_torch.train.trainer",
                       "gcl_tpu_torch.train.writer",
                       "gcl_tpu_torch.train.__main__",
                       "gcl_tpu_torch.parallel.mesh",
                       "gcl_tpu_torch.parallel.launch",
                       "gcl_tpu_torch.models.simpleunet",
                       "gcl_tpu_torch.models.projection_head",
                       "gcl_tpu_torch.models.mlp",
                       "gcl_tpu_torch.demo", "gcl_tpu_torch.eval_eth",
                       "gcl_tpu_torch.sc2_pcr.test_kitti",
                       "gcl_tpu_torch.sc2_pcr.test_3dmatch",
                       "gcl_tpu_torch.sc2_pcr.test_3dlomatch",
                       "gcl_tpu_torch.sc2_pcr.dataset",
                       "gcl_tpu_torch.sc2_pcr.utils.max_clique",
                       "gcl_tpu_torch.sc2_pcr.utils.sinkhorn",
                       "gcl_tpu_torch.train.import_torch",
                       "gcl_tpu_torch.data.legacy",
                       "gcl_tpu_torch.utils.file",
                       "gcl_tpu_torch.utils.misc",
                       "gcl_tpu_torch.utils.pointcloud",
                       "gcl_tpu_torch.utils.trajectory",
                       "gcl_tpu_torch.utils.visualization",
                       "gcl_tpu_torch.native")
           if n not in names]
print(len(names), bad + missing, build._lib is None and native._lib is None
      and not native._tried)
"""


def test_import_leaves_jax_out_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=300, check=True)
    line = out.stdout.strip().splitlines()[-1]
    n_modules, rest = line.split(" ", 1)
    assert rest == "[] True", line  # no JAX module, no library loaded
    assert int(n_modules) >= 53, line


def test_synth_lidar_is_bench_copy():
    import bench
    from gcl_tpu_torch.data.synthetic import synth_lidar

    for seed in (0, 5):
        a = synth_lidar(np.random.RandomState(seed), 3000)
        b = bench.synth_lidar(np.random.RandomState(seed), 3000)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gcl_tpu", "sklearn",
              "matplotlib")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_names_jax():
    """Every import statement of chip_smoke.py and of every module of the
    package, function-level imports included, by its syntax tree."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = [root / "chip_smoke.py"] + sorted(
        (root / "gcl_tpu_torch").rglob("*.py"))
    assert len(files) >= 46
    for path in files:
        bad = _imported_roots(path) & set(_FORBIDDEN)
        assert not bad, f"{path.name} imports {sorted(bad)}"


def test_bench_runs_on_the_cpu_when_asked():
    """python -m gcl_tpu_torch.bench refuses to run without a card unless
    --device cpu is given; on the CPU, at a small size, it prints bench.py's
    keys and names the search and the compute type that ran: the grid
    search and bfloat16 (root bench.py's) by default, float32 when asked."""
    base = [sys.executable, "-m", "gcl_tpu_torch.bench", "--batch_size", "1",
            "--points", "1500", "--nv", "512", "--iters", "1", "--reps", "1"]
    refused = subprocess.run(base, capture_output=True, text=True,
                             timeout=300)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr
    for extra, search, dtype in (
            ([], "grid_1.08", "bfloat16"),
            (["--search", "brute_force", "--compute_dtype", "float32"],
             "brute_force", "float32")):
        # two threads: the suite's workers already share the cores, and a
        # pool of all of them stalls at its barriers when they are busy
        out = subprocess.run(base + ["--device", "cpu"] + extra,
                             capture_output=True, text=True, timeout=600,
                             check=True, env={**os.environ,
                                              "OMP_NUM_THREADS": "2"})
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["search"] == search and res["device"] == "cpu"
        assert res["metric"] == "gcl_train_voxels_per_sec"
        assert res["compute_dtype"] == dtype and res["value"] > 0
        assert res["voxels_per_step"] > 1000
