"""Augmentation transforms and random SE(3) helpers (a copy of
gcl_tpu/data/transforms.py)."""
from __future__ import annotations

import numpy as np


def rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rotation about `axis` by angle theta (Rodrigues; the reference uses
    scipy expm of the cross-product matrix — identical result)."""
    axis = axis / np.linalg.norm(axis)
    K = np.cross(np.eye(3), axis)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def sample_random_trans(pcd: np.ndarray, randg,
                        rotation_range: float = 360) -> np.ndarray:
    """Random rotation + recenter at the cloud mean (reference :38-43).
    NOTE the reference passes np.pi/4 (radians) into a formula expecting
    degrees — we reproduce that behavior verbatim."""
    T = np.eye(4)
    R = rotation_matrix(randg.rand(3) - 0.5,
                        rotation_range * np.pi / 180.0 * (randg.rand(1)[0]
                                                          - 0.5))
    T[:3, :3] = R
    T[:3, 3] = R.dot(-np.mean(pcd, axis=0))
    return T


def follow_presampled_trans(pcd: np.ndarray, trans: np.ndarray
                            ) -> np.ndarray:
    """Same rotation as `trans`, recentered at this cloud's mean
    (reference :45-50)."""
    T = np.eye(4)
    R = trans[:3, :3]
    T[:3, :3] = R
    T[:3, 3] = R.dot(-np.mean(pcd, axis=0))
    return T


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, coords, feats):
        for t in self.transforms:
            coords, feats = t(coords, feats)
        return coords, feats


class Jitter:
    """Gaussian feature noise with probability p (reference :24-34)."""

    def __init__(self, mu=0, sigma=0.01, p=0.95):
        self.mu = mu
        self.sigma = sigma
        self.p = p

    def __call__(self, coords, feats):
        if np.random.rand() < self.p:
            feats = feats + np.random.randn(*feats.shape).astype(
                feats.dtype) * self.sigma + self.mu
        return coords, feats


class ChromaticShift:
    """Random color shift with probability p (reference :36-42)."""

    def __init__(self, mu=0, sigma=0.1, p=0.95):
        self.mu = mu
        self.sigma = sigma
        self.p = p

    def __call__(self, coords, feats):
        if np.random.rand() < self.p:
            feats[:, :3] = feats[:, :3] + np.random.randn(3).astype(
                feats.dtype) * self.sigma + self.mu
        return coords, feats
