"""The host C++ library (port of gcl_tpu/native/): ctypes bindings to
``voxel_ops.cpp`` (``voxelize``, ``radius_knn``, ``kernel_map``) and
``scan_reader.cpp`` (``ScanPrefetcher``), with numpy / scipy plain
versions that give the same answers where the library is not built.

The two sources beside this file are compiled by g++ at first use
(``-O3 -march=native -fPIC -fopenmp -std=c++17``, gcl_tpu's Makefile's
flags) into ``build/native/`` beside the package. The file name carries a
hash of the sources, the flags and the compiler's ``-march=native``
target, so an edited source, or another host CPU, builds anew. Concurrent
builders (test workers, data-loader workers) take a file lock, and the
library is written under a temporary name and renamed into place. Nothing
is built at import time.

A failed build is not silent: the compiler's message is kept
(``build_error()``), warned once, and every function takes its plain
version.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = ("voxel_ops.cpp", "scan_reader.cpp")
BUILD_DIR = HERE.parents[1] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
             "-Wall", "-shared")

_lib = None
_error: Optional[str] = None
_tried = False
_lock = threading.Lock()


def _target() -> str:
    """What -march=native means on this host (g++'s resolved target
    options), so a library built for one CPU is not loaded on another."""
    out = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True)
    return out.stdout


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    h.update(_target().encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    return BUILD_DIR / f"libgclnative_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder at a time
        if not path.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                res = subprocess.run(
                    [CXX, *CXX_FLAGS, "-o", tmp,
                     *(str(HERE / name) for name in SOURCES)],
                    capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"{CXX} failed ({res.returncode}):\n"
                                       f"{res.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gcl_voxelize.restype = ctypes.c_int
    lib.gcl_voxelize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64]
    lib.gcl_radius_knn.restype = None
    lib.gcl_radius_knn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
    lib.gcl_kernel_map.restype = None
    lib.gcl_kernel_map.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.gcl_reader_create.restype = ctypes.c_void_p
    lib.gcl_reader_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gcl_reader_destroy.restype = None
    lib.gcl_reader_destroy.argtypes = [ctypes.c_void_p]
    lib.gcl_reader_submit.restype = None
    lib.gcl_reader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gcl_reader_fetch.restype = ctypes.c_long
    lib.gcl_reader_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    return lib


def _ensure_built():
    """The library, built and loaded on the first call; None (with the
    reason in build_error(), warned once) if it cannot be."""
    global _lib, _error, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = f"{type(e).__name__}: {e}"
                warnings.warn("gcl_tpu_torch.native: the host library did "
                              "not build; the numpy / scipy plain versions "
                              f"run instead.\n{_error}", RuntimeWarning,
                              stacklevel=3)
            _tried = True
    return _lib


def available() -> bool:
    return _ensure_built() is not None


def build_error() -> Optional[str]:
    """Why the library is not loaded (the compiler's message), or None:
    None also before the first use, which builds it."""
    return _error


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _packed(coords: np.ndarray) -> np.ndarray:
    """voxel_ops.cpp's HashTable::pack: 21 bits an axis, offset by 2^20.
    The two agree on coordinates within +-2^20 (the library's hash slots
    are not packed, so coordinates 2^21 apart are not reliably merged
    there)."""
    c = (coords.astype(np.int64) + (1 << 20)) & 0x1FFFFF
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def _first_of_each(keys: np.ndarray) -> np.ndarray:
    """Ascending indices of each key's first occurrence."""
    _, first = np.unique(keys, return_index=True)
    return np.sort(first)


def voxelize_plain(pts: np.ndarray, voxel_size: float):
    """voxelize in numpy: the same float32 quotient as the library (points
    times the float32 inverse of the voxel size), the first point of each
    voxel in point order."""
    inv = np.float32(1.0) / np.float32(voxel_size)
    coords = np.floor(pts * inv).astype(np.int32)
    sel = _first_of_each(_packed(coords))
    return coords[sel], sel.astype(np.int32)


def voxelize(points: np.ndarray, voxel_size: float):
    """Unique voxels + representative point indices (first occurrence).
    Returns (coords int32[n,3], rep int32[n])."""
    pts = np.ascontiguousarray(points, np.float32)
    lib = _ensure_built()
    if lib is None:
        return voxelize_plain(pts, voxel_size)
    n = len(pts)
    out_c = np.empty((n, 3), np.int32)
    out_r = np.empty(n, np.int32)
    cnt = lib.gcl_voxelize(_fp(pts), n, voxel_size, _ip(out_c), _ip(out_r),
                           n)
    return out_c[:cnt].copy(), out_r[:cnt].copy()


def radius_knn_plain(q: np.ndarray, t: np.ndarray, radius: float, k: int):
    """radius_knn with scipy's cKDTree (float64 distances)."""
    from scipy.spatial import cKDTree

    d, idx = cKDTree(t).query(q, k=k, distance_upper_bound=radius)
    if k == 1:
        d, idx = d[:, None], idx[:, None]
    hit = np.isfinite(d)
    return np.where(hit, idx, 0).astype(np.int32), hit


def radius_knn(queries: np.ndarray, targets: np.ndarray, radius: float,
               k: int):
    """K nearest within radius (sorted). Returns (idx int32[nq,k],
    hit bool[nq,k])."""
    q = np.ascontiguousarray(queries, np.float32)
    t = np.ascontiguousarray(targets, np.float32)
    lib = _ensure_built()
    if lib is None:
        return radius_knn_plain(q, t, radius, k)
    nq = len(q)
    idx = np.empty((nq, k), np.int32)
    hit = np.empty((nq, k), np.uint8)
    lib.gcl_radius_knn(_fp(q), nq, _fp(t), len(t), radius, k, _ip(idx),
                       hit.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return idx, hit.astype(bool)


def kernel_map_plain(ic: np.ndarray, oc: np.ndarray,
                     off: np.ndarray) -> np.ndarray:
    """kernel_map in numpy: a sorted table of the input rows' packed keys
    (each key's first row) searched for every output + offset."""
    sel = _first_of_each(_packed(ic))
    keys = _packed(ic[sel])
    order = np.argsort(keys)
    table, rows = keys[order], sel[order]
    km = np.full((len(off), len(oc)), -1, np.int32)
    if len(table) == 0:
        return km
    for o, d in enumerate(off):
        want = _packed(oc.astype(np.int64) + d)
        pos = np.minimum(np.searchsorted(table, want), len(table) - 1)
        found = table[pos] == want
        km[o, found] = rows[pos[found]]
    return km


def kernel_map(in_coords: np.ndarray, out_coords: np.ndarray,
               offsets: np.ndarray) -> np.ndarray:
    """Host kernel-map builder: kmap[o, i] = row of in_coords at
    out_coords[i] + offsets[o], or -1 (single batch item)."""
    ic = np.ascontiguousarray(in_coords, np.int32)
    oc = np.ascontiguousarray(out_coords, np.int32)
    off = np.ascontiguousarray(offsets, np.int32)
    lib = _ensure_built()
    if lib is None:
        return kernel_map_plain(ic, oc, off)
    km = np.empty((len(off), len(oc)), np.int32)
    lib.gcl_kernel_map(_ip(ic), len(ic), _ip(oc), len(oc), _ip(off),
                       len(off), _ip(km))
    return km


class ScanPrefetcher:
    """Asynchronous scan-file prefetcher over the native thread pool
    (scan_reader.cpp). Submit paths ahead of time; ``fetch`` returns the
    float payload, blocking only if the read is still in flight, and
    reads synchronously a path never submitted, already fetched or
    evicted. Without the library every fetch is a synchronous numpy read.
    """

    def __init__(self, n_threads: int = 4, cache_entries: int = 64):
        self._lib = _ensure_built()
        self._h = None
        self._n_threads = n_threads
        self._cache_entries = cache_entries
        if self._lib is not None:
            self._h = self._lib.gcl_reader_create(n_threads,
                                                  cache_entries)
        self._pid = os.getpid()
        self._submitted: set = set()

    def __del__(self, _getpid=os.getpid):
        # never touch a handle inherited across fork: the worker threads
        # (and any locked mutex) do not survive into the child
        # (_getpid bound at class definition: os may be gone at shutdown)
        try:
            if (self._h is not None and self._lib is not None
                    and _getpid() == self._pid):
                self._lib.gcl_reader_destroy(self._h)
        except Exception:
            pass

    def _check_fork(self):
        if self._h is not None and os.getpid() != self._pid:
            # forked child: the inherited pool has no live threads --
            # abandon the handle (leaks the parent's table copy, but is
            # deadlock-safe) and build a fresh pool in this process
            self._h = self._lib.gcl_reader_create(self._n_threads,
                                                  self._cache_entries)
            self._pid = os.getpid()
            self._submitted = set()

    def submit(self, path: str):
        if self._h is None:
            return
        self._check_fork()
        if path not in self._submitted:
            self._submitted.add(path)
            self._lib.gcl_reader_submit(self._h, path.encode())

    def fetch(self, path: str, max_floats: int = 1 << 24) -> np.ndarray:
        """Raw float32 payload of ``path`` (consumes the cached entry);
        reads synchronously when not prefetched / no native lib."""
        self._check_fork()
        if self._h is not None and path in self._submitted:
            self._submitted.discard(path)
            buf = np.empty(max_floats, np.float32)
            n = self._lib.gcl_reader_fetch(self._h, path.encode(),
                                           _fp(buf), max_floats)
            if n >= 0:
                return buf[:n].copy()
        return np.fromfile(path, dtype=np.float32)
