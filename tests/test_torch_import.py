"""gcl_tpu_torch stands alone: it imports on a CPU-only machine without JAX,
flax or gcl_tpu, and importing it builds no kernel."""
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "gcl_tpu"))
print(len(names), bad, build._lib is None)
"""


def test_import_leaves_jax_out_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=300, check=True)
    line = out.stdout.strip().splitlines()[-1]
    n_modules, rest = line.split(" ", 1)
    assert rest == "[] True", line  # no JAX module, no library loaded
    assert int(n_modules) >= 20, line


def test_synth_lidar_is_bench_copy():
    import bench
    from gcl_tpu_torch.data.synthetic import synth_lidar

    for seed in (0, 5):
        a = synth_lidar(np.random.RandomState(seed), 3000)
        b = bench.synth_lidar(np.random.RandomState(seed), 3000)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
