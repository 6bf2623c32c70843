"""gcl_tpu_torch.native (the host C++ library: voxelize, radius_knn,
kernel_map, ScanPrefetcher) against gcl_tpu.native on the same arrays and
files, and against the port's numpy / scipy plain versions.

gcl_tpu's library is compiled from gcl_tpu/native/*.cpp with its
Makefile's flags into a temporary directory, and gcl_tpu.native._SO
points there for this module: tests/test_native.py runs `make` in place
in another worker. The port's library builds into build/native/ as it
does in use. Every comparison is exact; where g++ is absent the module
skips.
"""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch.utils.data

import gcl_tpu.native as jnative
from gcl_tpu_torch import native
from gcl_tpu_torch.data import kitti_io

from _torch_parity import build_gcl_tpu_native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is not installed")

OFFSETS = np.array([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1)], np.int32)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both packages' libraries built: gcl_tpu's in a temporary directory
    (its Makefile's flags), the port's where it builds in use."""
    so = build_gcl_tpu_native(tmp_path_factory.mktemp("gcl_tpu_native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", so)
        mp.setattr(jnative, "_lib", None)
        assert jnative.available()
        assert native.available(), native.build_error()
        assert native.build_error() is None
        yield


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _voxelize_three_ways(pts, voxel):
    ours = native.voxelize(pts, voxel)
    _equal(ours, jnative.voxelize(pts, voxel))
    _equal(ours, native.voxelize_plain(np.asarray(pts, np.float32), voxel))
    return ours


def _radius_knn_three_ways(q, t, radius, k):
    ours = native.radius_knn(q, t, radius, k)
    _equal(ours, jnative.radius_knn(q, t, radius, k))
    _equal(ours, native.radius_knn_plain(q, t, radius, k))
    return ours


def _kernel_map_three_ways(ic, oc, off):
    ours = native.kernel_map(ic, oc, off)
    np.testing.assert_array_equal(ours, jnative.kernel_map(ic, oc, off))
    np.testing.assert_array_equal(ours, native.kernel_map_plain(ic, oc, off))
    return ours


def test_voxelize(rng, libs):
    """tests/test_native.py's case: the voxel set, each representative
    quantizing to its voxel; both libraries and the plain version equal."""
    pts = rng.randn(5000, 3).astype(np.float32) * 5
    c, r = _voxelize_three_ways(pts, 0.3)
    oc = np.floor(pts / 0.3).astype(np.int32)
    assert {tuple(x) for x in c} == {tuple(x) for x in np.unique(oc, axis=0)}
    np.testing.assert_array_equal(np.floor(pts[r] / 0.3).astype(np.int32), c)
    # repeated points keep their first occurrence
    _voxelize_three_ways(np.concatenate([pts, pts[:500]]), 0.3)


def test_radius_knn(rng, libs):
    from scipy.spatial import cKDTree

    pts = rng.randn(3000, 3).astype(np.float32) * 4
    q = rng.randn(300, 3).astype(np.float32) * 4
    idx, hit = _radius_knn_three_ways(q, pts, 0.6, 5)
    tree = cKDTree(pts)
    for i in range(300):
        d, wi = tree.query(q[i], k=5, distance_upper_bound=0.6)
        want = [int(w) for w, dd in zip(np.atleast_1d(wi), np.atleast_1d(d))
                if np.isfinite(dd)]
        assert list(idx[i][hit[i]]) == want
    _radius_knn_three_ways(q, pts, 0.6, 1)


def test_kernel_map(rng, libs):
    ic = np.unique(rng.randint(-6, 6, (300, 3)), axis=0).astype(np.int32)
    oc = ic[::2]
    km = _kernel_map_three_ways(ic, oc, OFFSETS)
    table = {tuple(c): i for i, c in enumerate(map(tuple, ic))}
    want = np.array([[table.get(tuple(c + d), -1) for c in oc]
                     for d in OFFSETS])
    np.testing.assert_array_equal(km, want)
    # a repeated input row: its first occurrence, as the hash table keeps
    _kernel_map_three_ways(np.concatenate([ic, ic[:7]]), oc, OFFSETS)


def test_large_scan(rng, libs):
    """tests/test_native.py's 120,000-point scan (the card's smoke run
    takes the same shape): voxelize at 0.3 m, radius_knn of 20,000
    queries (r 0.45, k 5) and the 27-offset kernel map of the voxels,
    compared (a time limit is unsteady beside other test workers)."""
    pts = (rng.randn(120000, 3) * [20, 20, 2]).astype(np.float32)
    c, r = _voxelize_three_ways(pts, 0.3)
    assert len(c) > 100000
    idx, hit = _radius_knn_three_ways(pts[:20000], pts, 0.45, 5)
    assert hit[:, 0].all() and (idx[:, 0] == np.arange(20000)).all()
    km = _kernel_map_three_ways(c, c, OFFSETS)
    assert (km[13] == np.arange(len(c))).all()  # offset (0, 0, 0)


def test_voxelize_plain_takes_the_library_quotient(libs, monkeypatch):
    """The plain voxelize multiplies by the float32 inverse of the voxel
    size, as voxel_ops.cpp does. gcl_tpu's numpy fallback divides, and on
    this scan one point's quotient rounds across a voxel face: gcl_tpu's
    fallback disagrees with both libraries there, the port's does not."""
    pts = (np.random.RandomState(3).randn(120000, 3)
           * [20, 20, 2]).astype(np.float32)
    lib = _voxelize_three_ways(pts, 0.3)
    monkeypatch.setattr(jnative, "_ensure_built", lambda: None)
    fallback = jnative.voxelize(pts, 0.3)
    assert not all(np.array_equal(a, b) for a, b in zip(lib, fallback))
    inv = np.float32(1.0) / np.float32(0.3)
    face = np.floor(pts * inv) != np.floor(pts / np.float32(0.3))
    assert 0 < face.any(1).sum() <= 5


def _write_scans(tmp_path, rng, n, prefix, size=lambda i: 64 + i):
    paths, payloads = [], []
    for i in range(n):
        arr = rng.randn(size(i)).astype(np.float32)
        p = str(tmp_path / f"{prefix}_{i:02d}.bin")
        arr.tofile(p)
        paths.append(p)
        payloads.append(arr)
    return paths, payloads


def test_payloads_survive_cache_pressure(tmp_path, libs):
    """tests/test_native.py's case on both prefetchers: far more files
    submitted than cache entries, a second wave evicting the first's
    completed reads; every payload comes back bit-equal to the file and
    to gcl_tpu's."""
    readers = [native.ScanPrefetcher(n_threads=2, cache_entries=4),
               jnative.ScanPrefetcher(n_threads=2, cache_entries=4)]
    rng = np.random.RandomState(0)
    paths, payloads = _write_scans(tmp_path, rng, 24, "scan")
    for reader in readers:
        for p in paths:
            reader.submit(p)
    time.sleep(0.3)  # let the pools drain so eviction sees completed reads
    more, more_payloads = _write_scans(tmp_path, rng, 24, "wave2",
                                       size=lambda i: 32)
    for p in more:
        for reader in readers:
            reader.submit(p)
    for p, want in zip(paths + more, payloads + more_payloads):
        got = [reader.fetch(p) for reader in readers]
        assert got[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want, err_msg=p)
        np.testing.assert_array_equal(got[0], got[1], err_msg=p)


def test_unprefetched_fetch_reads_synchronously(tmp_path, libs):
    """A path never submitted, or fetched twice, is read from disk."""
    arr = np.arange(10, dtype=np.float32)
    p = str(tmp_path / "plain.bin")
    arr.tofile(p)
    for reader in (native.ScanPrefetcher(n_threads=1, cache_entries=4),
                   jnative.ScanPrefetcher(n_threads=1, cache_entries=4)):
        np.testing.assert_array_equal(reader.fetch(p), arr)
        reader.submit(p)
        np.testing.assert_array_equal(reader.fetch(p), arr)
        assert p not in reader._submitted
        np.testing.assert_array_equal(reader.fetch(p), arr)


class _Hinted(torch.utils.data.Dataset):
    """Each item hints its scan and the next one to the module's pool, as
    the datasets do, then reads its scan; also says whether the pool it
    read from lives in this process."""

    def __init__(self, paths):
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        kitti_io.prefetch_scans(self.paths[i:i + 2])
        pool = kitti_io._get_prefetcher()
        hinted = self.paths[i] in pool._submitted
        xyz = kitti_io.read_velodyne_bin(self.paths[i])
        return xyz, hinted and pool._pid == os.getpid()


def test_pool_in_forked_loader_workers(tmp_path, libs, monkeypatch):
    """A parent whose pool holds hinted, unread scans forks two
    torch.utils.data workers: each builds a fresh pool (the inherited one
    has no threads), and every scan comes back bit-equal to the file and
    to an in-process pass."""
    monkeypatch.setattr(kitti_io, "_prefetcher", None)
    rng = np.random.RandomState(1)
    paths, payloads = _write_scans(tmp_path, rng, 12, "scan",
                                   size=lambda i: 4 * (100 + 7 * i))
    ds = _Hinted(paths)
    kitti_io.prefetch_scans(paths)  # the parent's pool, mid-flight at fork
    inproc = [ds[i] for i in range(len(ds))]
    kitti_io.prefetch_scans(paths)
    loader = torch.utils.data.DataLoader(
        ds, batch_size=None, num_workers=2, multiprocessing_context="fork")
    forked = list(loader)
    for want, (a, a_pool), (b, b_pool) in zip(payloads, inproc, forked):
        np.testing.assert_array_equal(a, want.reshape(-1, 4)[:, :3])
        np.testing.assert_array_equal(np.asarray(b), a)
        assert a_pool and bool(b_pool)
    assert os.getpid() == kitti_io._prefetcher._pid


def test_failed_build_warns_once_and_falls_back(tmp_path, monkeypatch):
    """Without a compiler: one RuntimeWarning carrying the reason,
    build_error() keeps it, the functions take their plain versions and
    the prefetcher reads synchronously."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    for name, value in (("_lib", None), ("_error", None), ("_tried", False)):
        monkeypatch.setattr(native, name, value)
    with pytest.warns(RuntimeWarning, match="did not build"):
        assert not native.available()
    assert "no-such-g++" in native.build_error()
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pts = np.random.RandomState(0).randn(500, 3).astype(np.float32)
        _equal(native.voxelize(pts, 0.3), native.voxelize_plain(pts, 0.3))
        reader = native.ScanPrefetcher()
        p = str(tmp_path / "x.bin")
        pts.tofile(p)
        reader.submit(p)
        np.testing.assert_array_equal(reader.fetch(p), pts.reshape(-1))


def test_concurrent_builds_leave_one_library(tmp_path):
    """Two processes building into one empty directory at once: both load
    a library, and one file is left (a lock, a temporary name renamed into
    place)."""
    probe = ("import sys, pathlib; from gcl_tpu_torch import native; "
             "native.BUILD_DIR = pathlib.Path(sys.argv[1]); "
             "print(native.available(), native.library_path().name)")
    procs = [subprocess.Popen([sys.executable, "-c", probe, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0] == outs[1] and outs[0][0] == "True"
    assert sorted(f.name for f in tmp_path.glob("*.so")) == [outs[0][1]]
