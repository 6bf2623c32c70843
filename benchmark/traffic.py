"""The one generator of the benchmark's inputs. A cell's file holds the
parameters (``traffic``): how many points a scan has, how a scan is
shaped, how the clouds of a sample or the two scans of a pair are placed,
and how many distinct batches or pairs the pool holds. Everything is
drawn on the device from the run's seed with a torch.Generator, in a few
calls, so the same seed gives the same inputs and every seed the same
sizes."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``salt``) of a run."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) % (1 << 63))
    return g


def scans(gen: torch.Generator, n: int, p: dict, device) -> torch.Tensor:
    """``n`` LiDAR-like scans f32[n, P, 3] (root bench.py's synth_lidar
    drawn on the device): a ground disc of ``ground_share`` of the points
    out to ``ground_radius_m``, and the rest around ``objects`` vertical
    structures spread ``object_spread_m`` in x and y."""
    pts = p["points"]
    n_ground = int(pts * p["ground_share"])
    n_obj = pts - n_ground

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    r = torch.sqrt(rand(n, n_ground)) * p["ground_radius_m"]
    th = rand(n, n_ground) * (2 * math.pi)
    ground = torch.stack([r * torch.cos(th), r * torch.sin(th),
                          randn(n, n_ground) * p["ground_sigma_z_m"]], -1)
    spread = torch.tensor([p["object_spread_m"], p["object_spread_m"], 0.0],
                          device=device)
    centers = randn(n, p["objects"], 3) * spread
    pick = torch.randint(0, p["objects"], (n, n_obj), generator=gen,
                         device=device)
    size = torch.tensor(p["object_sigma_m"], device=device)
    lift = torch.tensor([0.0, 0.0, p["object_lift_m"]], device=device)
    obj = (torch.gather(centers, 1, pick[..., None].expand(-1, -1, 3))
           + randn(n, n_obj, 3) * size + lift)
    return torch.cat([ground, obj], 1).contiguous()


def rigid(gen: torch.Generator, n: int, p: dict, device) -> torch.Tensor:
    """``n`` rigid motions f32[n, 4, 4]: a yaw uniform in +-``max_yaw_deg``
    and a horizontal shift of a length uniform in [``min_dist_m``,
    ``max_dist_m``] in a uniform direction."""
    u = torch.rand((n, 3), generator=gen, device=device)
    yaw = torch.deg2rad((2 * u[:, 0] - 1) * p["max_yaw_deg"])
    dist = p["min_dist_m"] + (p["max_dist_m"] - p["min_dist_m"]) * u[:, 1]
    head = 2 * math.pi * u[:, 2]
    t = torch.zeros((n, 4, 4), device=device)
    c, s = torch.cos(yaw), torch.sin(yaw)
    t[:, 0, 0], t[:, 0, 1], t[:, 1, 0], t[:, 1, 1] = c, -s, s, c
    t[:, 2, 2] = t[:, 3, 3] = 1.0
    t[:, 0, 3], t[:, 1, 3] = dist * torch.cos(head), dist * torch.sin(head)
    return t


def moved(points: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """points [n, P, 3] under the motions t [n, 4, 4]."""
    return points @ t[:, :3, :3].transpose(1, 2) + t[:, None, :3, 3]


def colocation_batches(seed: int, p: dict, device) -> List[Tuple]:
    """The pool of a GCL training cell: ``pool`` batches of ``batch``
    samples x ``clouds`` scans (root bench.py's bench_batch: the
    neighbours displaced along a trajectory by ``trajectory_step_m``),
    each (points [B, C, P, 3], pmask, transforms [B, C, 4, 4], radius [B])."""
    gen = generator(seed, 1, device)
    b, c = p["batch"], p["clouds"]
    out = []
    for _ in range(p["pool"]):
        pts = scans(gen, b * c, p, device).reshape(b, c, p["points"], 3)
        t = torch.eye(4, device=device).repeat(b, c, 1, 1)
        for k in range(1, c):
            t[:, k, 0, 3] = ((k + 1) // 2) * p["trajectory_step_m"] * (
                1 if k % 2 else -1)
        pmask = torch.ones(pts.shape[:3], dtype=torch.bool, device=device)
        radius = torch.full((b,), p["group_radius_m"], device=device)
        out.append((pts, pmask, t, radius))
    return out


def pair_batches(seed: int, p: dict, device) -> List[Tuple]:
    """The pool of an FCGF training cell: ``pool`` batches of ``batch``
    pairs, the second scan of each a rigid motion of the first, each
    (points0 [B, P, 3], pmask0, points1, pmask1, trans [B, 4, 4] taking
    cloud 0 onto cloud 1, radius [B])."""
    gen = generator(seed, 2, device)
    b = p["batch"]
    out = []
    for _ in range(p["pool"]):
        p0 = scans(gen, b, p, device)
        t = rigid(gen, b, p, device)
        pmask = torch.ones(p0.shape[:2], dtype=torch.bool, device=device)
        radius = torch.full((b,), p["pair_radius_m"], device=device)
        out.append((p0, pmask, moved(p0, t), pmask.clone(), t, radius))
    return out


def registration_pairs(seed: int, p: dict, device) -> List[Dict]:
    """The pool of a registration cell: ``pool`` pairs, each {points [2, P,
    3], pmask [2, P], trans [4, 4] taking cloud 0 onto cloud 1}."""
    gen = generator(seed, 3, device)
    n = p["pool"]
    p0 = scans(gen, n, p, device)
    t = rigid(gen, n, p, device)
    p1 = moved(p0, t)
    pmask = torch.ones((2, p["points"]), dtype=torch.bool, device=device)
    return [{"points": torch.stack([p0[i], p1[i]]), "pmask": pmask,
             "trans": t[i]} for i in range(n)]


def pair_seed(seed: int, index: int) -> int:
    """The seed of the host generators of one pair of the window: the
    keypoint and node draws of SC2-PCR, the subsample and the minimal
    samples of RANSAC."""
    return (int(seed) * 7919 + index) % (1 << 62)
