// Native host-side geometry kernels for the data pipeline (a copy of
// gcl_tpu/native/voxel_ops.cpp, a source of gcl_tpu_torch).
//
// The reference delegates these to external C++ libraries
// (MinkowskiEngine sparse_quantize, Open3D KDTreeFlann). This library
// provides the framework's own implementations for the host-bound stages:
// open-addressing voxel hashing and a uniform spatial grid for
// radius-KNN. OpenMP-parallel. Exposed via ctypes
// (gcl_tpu_torch/native/__init__.py) with numpy / scipy plain versions.
//
// Built by gcl_tpu_torch/native/__init__.py at first use, with
// scan_reader.cpp, into build/native/.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// 64-bit mix hash for 3 int coordinates.
inline uint64_t hash_coord(int32_t x, int32_t y, int32_t z) {
  uint64_t h = 1469598103934665603ull;
  const int32_t v[3] = {x, y, z};
  for (int i = 0; i < 3; ++i) {
    h ^= static_cast<uint32_t>(v[i]);
    h *= 1099511628211ull;
  }
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  return h;
}

struct HashTable {
  // open addressing, linear probing; key = packed coords, value = index
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;
  static constexpr uint64_t EMPTY = ~0ull;

  explicit HashTable(size_t n) {
    size_t cap = 16;
    while (cap < n * 2) cap <<= 1;
    keys.assign(cap, EMPTY);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  static uint64_t pack(int32_t x, int32_t y, int32_t z) {
    // 21 bits per axis, offset to non-negative
    return (static_cast<uint64_t>(static_cast<uint32_t>(x + 1048576) & 0x1FFFFF) << 42)
         | (static_cast<uint64_t>(static_cast<uint32_t>(y + 1048576) & 0x1FFFFF) << 21)
         | (static_cast<uint64_t>(static_cast<uint32_t>(z + 1048576) & 0x1FFFFF));
  }

  // insert if absent; returns existing or new value
  int32_t insert(int32_t x, int32_t y, int32_t z, int32_t val) {
    uint64_t key = pack(x, y, z);
    uint64_t slot = hash_coord(x, y, z) & mask;
    for (;;) {
      if (keys[slot] == EMPTY) {
        keys[slot] = key;
        vals[slot] = val;
        return val;
      }
      if (keys[slot] == key) return vals[slot];
      slot = (slot + 1) & mask;
    }
  }

  int32_t find(int32_t x, int32_t y, int32_t z) const {
    uint64_t key = pack(x, y, z);
    uint64_t slot = hash_coord(x, y, z) & mask;
    for (;;) {
      if (keys[slot] == EMPTY) return -1;
      if (keys[slot] == key) return vals[slot];
      slot = (slot + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Quantize points to unique voxels (first occurrence kept, like
// ME.utils.sparse_quantize(return_index=True)).
// out_coords: [cap,3] int32, out_rep: [cap] int32 (index of representative
// point). Returns the number of voxels written (<= cap).
int gcl_voxelize(const float* pts, int64_t n, float voxel_size,
                 int32_t* out_coords, int32_t* out_rep, int64_t cap) {
  HashTable table(static_cast<size_t>(n));
  int64_t count = 0;
  const float inv = 1.0f / voxel_size;
  for (int64_t i = 0; i < n; ++i) {
    int32_t cx = static_cast<int32_t>(std::floor(pts[i * 3 + 0] * inv));
    int32_t cy = static_cast<int32_t>(std::floor(pts[i * 3 + 1] * inv));
    int32_t cz = static_cast<int32_t>(std::floor(pts[i * 3 + 2] * inv));
    int32_t got = table.insert(cx, cy, cz, static_cast<int32_t>(count));
    if (got == count) {  // new voxel
      if (count < cap) {
        out_coords[count * 3 + 0] = cx;
        out_coords[count * 3 + 1] = cy;
        out_coords[count * 3 + 2] = cz;
        out_rep[count] = static_cast<int32_t>(i);
      }
      ++count;
    }
  }
  return static_cast<int>(count < cap ? count : cap);
}

// K nearest targets within `radius` per query (sorted by distance), via a
// uniform grid with cell = radius. idx: [nq*k], hit: [nq*k] (0/1).
void gcl_radius_knn(const float* q, int64_t nq, const float* t, int64_t nt,
                    float radius, int k, int32_t* idx, uint8_t* hit) {
  // bucket targets by cell
  HashTable cells(static_cast<size_t>(nt) + 1);
  std::vector<int32_t> cell_of(nt);
  std::vector<int32_t> head;  // first target idx per cell id
  std::vector<int32_t> next(nt, -1);
  const float inv = 1.0f / radius;
  int32_t n_cells = 0;
  for (int64_t i = 0; i < nt; ++i) {
    int32_t cx = static_cast<int32_t>(std::floor(t[i * 3 + 0] * inv));
    int32_t cy = static_cast<int32_t>(std::floor(t[i * 3 + 1] * inv));
    int32_t cz = static_cast<int32_t>(std::floor(t[i * 3 + 2] * inv));
    int32_t cid = cells.insert(cx, cy, cz, n_cells);
    if (cid == n_cells) {
      head.push_back(-1);
      ++n_cells;
    }
    cell_of[i] = cid;
  }
  for (int64_t i = nt - 1; i >= 0; --i) {  // preserve ascending order
    next[i] = head[cell_of[i]];
    head[cell_of[i]] = static_cast<int32_t>(i);
  }

  const float r2 = radius * radius;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 256)
#endif
  for (int64_t i = 0; i < nq; ++i) {
    float qx = q[i * 3 + 0], qy = q[i * 3 + 1], qz = q[i * 3 + 2];
    int32_t cx = static_cast<int32_t>(std::floor(qx * inv));
    int32_t cy = static_cast<int32_t>(std::floor(qy * inv));
    int32_t cz = static_cast<int32_t>(std::floor(qz * inv));
    // best-k via insertion into small arrays
    std::vector<float> bd(k, 1e30f);
    std::vector<int32_t> bi(k, -1);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          int32_t cid = cells.find(cx + dx, cy + dy, cz + dz);
          if (cid < 0) continue;
          for (int32_t j = head[cid]; j >= 0; j = next[j]) {
            float ddx = t[j * 3 + 0] - qx;
            float ddy = t[j * 3 + 1] - qy;
            float ddz = t[j * 3 + 2] - qz;
            float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 > r2 || d2 >= bd[k - 1]) continue;
            int p = k - 1;
            while (p > 0 && bd[p - 1] > d2) {
              bd[p] = bd[p - 1];
              bi[p] = bi[p - 1];
              --p;
            }
            bd[p] = d2;
            bi[p] = j;
          }
        }
    for (int p = 0; p < k; ++p) {
      idx[i * k + p] = bi[p] < 0 ? 0 : bi[p];
      hit[i * k + p] = bi[p] >= 0 ? 1 : 0;
    }
  }
}

// Kernel map: kmap[o * n_out + i] = index of (out_coords[i] + offsets[o])
// in in_coords, or -1. Coordinates are int32 [n,3] (single batch item —
// callers loop over batch items).
void gcl_kernel_map(const int32_t* in_coords, int64_t n_in,
                    const int32_t* out_coords, int64_t n_out,
                    const int32_t* offsets, int64_t n_off, int32_t* kmap) {
  HashTable table(static_cast<size_t>(n_in));
  for (int64_t i = 0; i < n_in; ++i)
    table.insert(in_coords[i * 3], in_coords[i * 3 + 1],
                 in_coords[i * 3 + 2], static_cast<int32_t>(i));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n_out; ++i) {
    int32_t x = out_coords[i * 3], y = out_coords[i * 3 + 1],
            z = out_coords[i * 3 + 2];
    for (int64_t o = 0; o < n_off; ++o) {
      kmap[o * n_out + i] = table.find(
          x + offsets[o * 3], y + offsets[o * 3 + 1],
          z + offsets[o * 3 + 2]);
    }
  }
}

}  // extern "C"
