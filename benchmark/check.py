"""The numbers that decide ``correct``: what the timed path produced held
against the plain reference, each with the limit its cell's file states.

Training: each step's loss (relative to the reference's), and the first
gradient's norm and the parameters' change over the first steps, leaf by
leaf as the gap between the program's norm and the reference's over the
larger of the reference's norm of that leaf and of the median leaf, taken
by the worst leaf and by the median leaf. Leaves whose reference gradient
is under a thousandth of the median leaf's move by round-off alone and
are left out of the change. A cell's file says which numbers it holds to
a limit; the run prints the others as readings.
Registration: voxels that differ (an exact count), the widest feature
gap, and the gap between the program's transform and the one the
reference's estimator gives from the program's own features; beside
them, as readings, the gap to the reference's whole pipeline (its
estimator on its own features)."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

ROUND_OFF_SHARE = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def moving_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's norm."""
    n = _norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= ROUND_OFF_SHARE * med]


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves=None) -> Dict[str, float]:
    """Each leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    keys = list(rn) if leaves is None else leaves
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def train_diagnostics(prog: dict, ref: dict) -> dict:
    """What a look at a training cell's numbers needs: each step's loss
    gap, and per measure the median leaf's gap and the three worst leaves
    with their gaps and their reference norms over the median's."""
    out = {"loss_gaps": [abs(a - b) / max(abs(b), 1e-30)
                         for a, b in zip(prog["loss"], ref["loss"])]}
    moved = moving_leaves(ref["grad"])
    dp = {k: prog["p"][k] - prog["p0"][k] for k in prog["p"]}
    dr = {k: ref["p"][k] - ref["p0"][k] for k in ref["p"]}
    for name, (a, b, leaves) in {"grad": (prog["grad"], ref["grad"], None),
                                 "update": (dp, dr, moved)}.items():
        gaps = _leaf_gaps(a, b, leaves)
        rn = _norms(b)
        med = statistics.median(rn.values())
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        out[name] = {"median_leaf": statistics.median(gaps.values()),
                     "worst": [[k, v, rn[k] / med] for k, v in worst]}
    return out


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """A training cell's numbers over its first steps: the worst step's
    loss gap; the first gradient's and the change's leaf gaps by the
    worst leaf (``grad_gap``, ``update_gap``) and by the median leaf
    (``*_median``). ``prog`` and ``ref`` each {"loss" [per step], "grad"
    {leaf}, "p0" {leaf}, "p" {leaf}}."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["loss"], ref["loss"]))
    if not all(math.isfinite(x) for x in prog["loss"]):
        loss_gap = math.inf
    moved = moving_leaves(ref["grad"])
    dp = {k: prog["p"][k] - prog["p0"][k] for k in prog["p"]}
    dr = {k: ref["p"][k] - ref["p0"][k] for k in ref["p"]}
    grad = _leaf_gaps(prog["grad"], ref["grad"])
    update = _leaf_gaps(dp, dr, moved)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad.values()),
            "update_gap": max(update.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "update_gap_median": statistics.median(update.values())}


def vox_mismatch(prog, ref) -> int:
    """Voxels whose coordinates, mask or representative point differ."""
    bad = (prog.mask != ref.mask)
    bad |= (prog.coords != ref.coords).any(-1)
    bad |= (prog.xyz != ref.xyz).any(-1)
    return int(bad.sum())


def feat_gap(prog: torch.Tensor, ref: torch.Tensor, mask) -> float:
    """The widest gap of a valid voxel's feature."""
    d = (prog.float() - ref.float()).abs().amax(-1)
    return float(torch.where(mask, d, 0.0).max())


def pose_gaps(prog: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """(translation gap m, rotation gap deg) between two transforms."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    dt = float(torch.linalg.vector_norm(prog[:3, 3] - ref[:3, 3]))
    # the angle of R_prog R_ref^T from the chord ||R_prog - R_ref||_F =
    # 2 sqrt(2) sin(angle / 2), exact near 0 where an arccos is not
    chord = float(torch.linalg.matrix_norm(prog[:3, :3] - ref[:3, :3]))
    dr = math.degrees(2 * math.asin(min(1.0, chord / (2 * math.sqrt(2)))))
    return dt, dr


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is finite and at most its limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)
