"""Synthetic LiDAR scans (numpy only), the input of the serving benchmark.

A verbatim copy of ``synth_lidar`` in the repository's ``bench.py``, so the
port needs nothing outside its own package.
"""
import numpy as np


def synth_lidar(rng, n_points):
    """LiDAR-like scan: ground disc + vertical structures, ~120 m spread."""
    n_ground = int(n_points * 0.6)
    r = np.sqrt(rng.rand(n_ground)) * 55.0
    th = rng.rand(n_ground) * 2 * np.pi
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       rng.randn(n_ground) * 0.05], 1)
    n_obj = n_points - n_ground
    centers = rng.randn(64, 3) * [18, 18, 0]
    pick = rng.randint(0, 64, n_obj)
    obj = centers[pick] + rng.randn(n_obj, 3) * [0.6, 0.6, 1.2] \
        + [0, 0, 1.5]
    return np.concatenate([ground, obj]).astype(np.float32)
