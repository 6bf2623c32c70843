"""3DMatch-format ``gt.log`` trajectory IO (a copy of
gcl_tpu/utils/trajectory.py).

File format (capability parity with reference ``util/trajectory.py:16-38``):
records of one whitespace-separated integer metadata line (fragment ids +
total count) followed by a ``dim x dim`` pose matrix, one row per line.
Implemented here as a whole-file block parse over a token matrix rather
than the reference's stateful readline loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrajectoryEntry:
    metadata: tuple  # ints from the header line (usually (i, j, n_total))
    pose: np.ndarray  # [dim, dim] float64


def read_trajectory(filename, dim=4):
    """Parse a gt.log into a list of TrajectoryEntry.

    Every record spans ``dim + 1`` lines; the header line may carry any
    number of integer fields, so lines are parsed individually and the
    pose rows are stacked per record.
    """
    with open(filename) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    rec = dim + 1
    if len(lines) % rec:
        raise ValueError(
            f"{filename}: {len(lines)} non-empty lines is not a multiple "
            f"of {rec} (dim={dim})")
    entries = []
    for start in range(0, len(lines), rec):
        meta = tuple(int(tok) for tok in lines[start])
        pose = np.array(lines[start + 1:start + rec], dtype=np.float64)
        if pose.shape != (dim, dim):
            raise ValueError(f"{filename}: bad pose block at line {start}")
        entries.append(TrajectoryEntry(meta, pose))
    return entries


def write_trajectory(traj, filename, dim=4):
    """Write TrajectoryEntry records (or anything with .metadata/.pose)."""
    with open(filename, "w") as f:
        for entry in traj:
            print(*entry.metadata, file=f)
            np.savetxt(f, np.asarray(entry.pose)[:dim, :dim], fmt="%.12f",
                       delimiter=" ")
