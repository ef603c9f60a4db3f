// Native host runtime of visfd_tpu_torch (the floods are a copy of the
// JAX package's visfd_tpu/native/visfd_native.cpp): the inherently
// sequential, priority-ordered flood algorithms that stay on the host
// while the dense voxel math runs on the GPU, and the text formatter of
// the blob lists.
//
// The floods reproduce the reference's sequential C++ semantics exactly
// (same priority ordering, same tie-breaking, same label states):
//   * visfd_watershed_flood  ~ Watershed        (segmentation.hpp:240-468)
//   * visfd_connect_flood    ~ LabelConnected   (connect.hpp:431-809)
//   * visfd_nms              ~ DiscardOverlappingBlobs (feature.hpp:720-913)
// and
//   * visfd_format_rows_g6   writes float64 rows as text, each value as
//     an ostream's default (printf's %.6g, Python's f"{v:.6g}")
//
// visfd_tpu_torch.segment.connect._flood_python is the plain (and
// bit-identical) twin of the connect flood, and io/coords.fmt_g the
// twin of the formatter, which the tests hold them against;
// visfd_tpu_torch.native builds this file at first use and loads it
// through ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC visfd_native.cpp -o libvisfd_native.so

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct QEnt {
  double score;
  int64_t basin;
  int32_t ix, iy, iz;
};

// priority_queue pops the *largest* element under this less-than.
// Pop order required (matching the reference's
// priority_queue<tuple<-score, basin, (ix,iy,iz)>>):
// smallest score first; ties -> largest basin id; ties -> largest
// (ix, iy, iz) lexicographically.
struct QCmp {
  bool operator()(const QEnt &a, const QEnt &b) const {
    if (a.score != b.score) return a.score > b.score;
    if (a.basin != b.basin) return a.basin < b.basin;
    if (a.ix != b.ix) return a.ix < b.ix;
    if (a.iy != b.iy) return a.iy < b.iy;
    return a.iz < b.iz;
  }
};

using Heap = std::priority_queue<QEnt, std::vector<QEnt>, QCmp>;

inline bool in_bounds(int64_t z, int64_t y, int64_t x,
                      int64_t nz, int64_t ny, int64_t nx) {
  return 0 <= z && z < nz && 0 <= y && y < ny && 0 <= x && x < nx;
}

// TraceProductSym3 as actually compiled in the reference (constant
// out-of-bounds indexing quirk; see visfd_tpu_torch.segment.connect docs).
inline double trace_product_quirk(const float *a, const float *b) {
  return 2.0 * (double)a[0] * b[0]
       + (double)a[0] * b[1] + (double)a[1] * b[0]
       + (double)a[1] * b[1]
       + (double)a[1] * b[2] + (double)a[2] * b[1]
       + 2.0 * (double)a[2] * b[2];
}

inline double frobenius_quirk(const float *a) {
  double t = trace_product_quirk(a, a);
  return t > 0.0 ? std::sqrt(t) : 0.0;
}

}  // namespace

extern "C" {

// Meyer priority-flood (segmentation.hpp:240-468).
//
// labels: int64 (nz,ny,nx), fully overwritten.
//   States: -1 = UNDEFINED, 0 = WATERSHED_BOUNDARY, 1..n = basins.
// seeds_xyz: (n_seeds, 3) int32 as (ix, iy, iz); seed_scores: raw
//   image values at the seeds. sign: +1 minima flood, -1 maxima.
// valid: uint8 mask or nullptr. offs: (n_offs, 3) int32 (dz, dy, dx).
// Returns 0 on success.
int64_t visfd_watershed_flood(
    const float *src, const uint8_t *valid,
    int64_t nz, int64_t ny, int64_t nx,
    const int32_t *seeds_xyz, const float *seed_scores, int64_t n_seeds,
    const int32_t *offs, int64_t n_offs,
    double sign, double halt_threshold, int32_t show_boundaries,
    int64_t *labels) {
  const int64_t UNDEF = -1, BOUNDARY = 0;
  const int64_t QUEUED = n_seeds + 2;
  const int64_t n = nz * ny * nx;
  for (int64_t i = 0; i < n; ++i) labels[i] = UNDEF;

  Heap q;
  for (int64_t i = 0; i < n_seeds; ++i) {
    int32_t ix = seeds_xyz[3 * i], iy = seeds_xyz[3 * i + 1],
            iz = seeds_xyz[3 * i + 2];
    q.push(QEnt{(double)seed_scores[i] * sign, i, ix, iy, iz});
    labels[((int64_t)iz * ny + iy) * nx + ix] = QUEUED;
  }

  while (!q.empty()) {
    QEnt e = q.top();
    q.pop();
    const int64_t at = ((int64_t)e.iz * ny + e.iy) * nx + e.ix;
    if (e.score > halt_threshold * sign) { labels[at] = UNDEF; continue; }
    if (valid && !valid[at]) { labels[at] = UNDEF; continue; }
    labels[at] = e.basin + 1;
    for (int64_t k = 0; k < n_offs; ++k) {
      const int64_t z = e.iz + offs[3 * k], y = e.iy + offs[3 * k + 1],
                    x = e.ix + offs[3 * k + 2];
      if (!in_bounds(z, y, x, nz, ny, nx)) continue;
      const int64_t ni = (z * ny + y) * nx + x;
      if (valid && !valid[ni]) continue;
      const int64_t nlab = labels[ni];
      if (nlab == BOUNDARY || nlab == QUEUED) continue;
      if (nlab == UNDEF) {
        labels[ni] = QUEUED;
        q.push(QEnt{(double)src[ni] * sign, e.basin,
                    (int32_t)x, (int32_t)y, (int32_t)z});
      } else if (nlab != labels[at] && show_boundaries) {
        labels[at] = BOUNDARY;
      }
    }
  }
  return 0;
}

// LabelConnected flood (connect.hpp:431-809): watershed-like flood
// with per-voxel discard gates (precomputed on device, passed in) and
// per-link tensor/vector compatibility gates, merging colliding
// basins into clusters (union structure) and propagating direction
// sign standardization.
//
// labels: int64 (nz,ny,nx), overwritten; states: basin ids 0..n-1,
//   UNDEF = n_seeds+1 (left as-is for never-reached voxels), QUEUED
//   internal.
// tensor: (nz,ny,nx,6) float or nullptr; vector_: (nz,ny,nx,3) float
//   or nullptr (both present iff tensor gating is on, matching the
//   reference's quirk of gating the vector check on the tensor).
// vec_std: (nz,ny,nx,3) float in/out or nullptr.
// basin2cluster: int64 (n_seeds) out; basin2polarity: int8 out.
// Returns 1 if any voxel link was cut due to polarity mismatch.
int64_t visfd_connect_flood(
    const float *sal, const uint8_t *valid, const uint8_t *discard,
    int64_t nz, int64_t ny, int64_t nx,
    const int32_t *seeds_xyz, const float *seed_scores, int64_t n_seeds,
    const int32_t *offs, int64_t n_offs,
    double sign, double threshold_saliency,
    const float *tensor, const float *vector_,
    double threshold_tensor_neighbor, double threshold_vector_neighbor,
    int32_t consider_sign,
    float *vec_std,
    int64_t *labels, int64_t *basin2cluster, int8_t *basin2polarity) {
  const int64_t UNDEF = n_seeds + 1;
  const int64_t QUEUED = n_seeds + 2;
  const int64_t n = nz * ny * nx;
  for (int64_t i = 0; i < n; ++i) labels[i] = UNDEF;

  std::vector<std::vector<int64_t>> cluster2basins((size_t)n_seeds);
  for (int64_t i = 0; i < n_seeds; ++i) {
    basin2cluster[i] = i;
    basin2polarity[i] = 1;
    cluster2basins[(size_t)i].push_back(i);
  }

  Heap q;
  for (int64_t i = 0; i < n_seeds; ++i) {
    int32_t ix = seeds_xyz[3 * i], iy = seeds_xyz[3 * i + 1],
            iz = seeds_xyz[3 * i + 2];
    q.push(QEnt{(double)seed_scores[i] * sign, i, ix, iy, iz});
    labels[((int64_t)iz * ny + iy) * nx + ix] = QUEUED;
  }

  bool cut_due_to_polarity = false;

  while (!q.empty()) {
    QEnt e = q.top();
    q.pop();
    const int64_t at = ((int64_t)e.iz * ny + e.iy) * nx + e.ix;
    if (e.score > threshold_saliency * sign) { labels[at] = UNDEF; continue; }
    if (valid && !valid[at]) { labels[at] = UNDEF; continue; }
    if (discard[at]) {
      labels[at] = UNDEF;
      if (seeds_xyz[3 * e.basin] == e.ix && seeds_xyz[3 * e.basin + 1] == e.iy
          && seeds_xyz[3 * e.basin + 2] == e.iz)
        basin2cluster[e.basin] = -1;
      continue;
    }
    labels[at] = e.basin;

    for (int64_t k = 0; k < n_offs; ++k) {
      const int64_t z = e.iz + offs[3 * k], y = e.iy + offs[3 * k + 1],
                    x = e.ix + offs[3 * k + 2];
      if (!in_bounds(z, y, x, nz, ny, nx)) continue;
      const int64_t ni = (z * ny + y) * nx + x;
      if (valid && !valid[ni]) continue;

      // per-link gates (connect.hpp:625-673, incl. the reference's
      // quirk: the vector check is gated on the tensor being present
      // and its signed branch uses threshold_tensor_neighbor)
      if (tensor) {
        const float *ti = tensor + 6 * at, *tj = tensor + 6 * ni;
        if (trace_product_quirk(ti, tj)
            < threshold_tensor_neighbor * frobenius_quirk(ti)
              * frobenius_quirk(tj))
          continue;
        if (vector_) {  // tensor without vector: skip the vector gate
          const float *vi = vector_ + 3 * at, *vj = vector_ + 3 * ni;
          const double dot = (double)vi[0] * vj[0] + (double)vi[1] * vj[1]
                           + (double)vi[2] * vj[2];
          const double li2 = (double)vi[0] * vi[0] + (double)vi[1] * vi[1]
                           + (double)vi[2] * vi[2];
          const double lj2 = (double)vj[0] * vj[0] + (double)vj[1] * vj[1]
                           + (double)vj[2] * vj[2];
          if (consider_sign) {
            if (dot < threshold_tensor_neighbor * std::sqrt(li2)
                      * std::sqrt(lj2))
              continue;
          } else {
            if (dot * dot < threshold_vector_neighbor
                            * threshold_vector_neighbor * li2 * lj2)
              continue;
          }
        }
      }

      const int64_t nlab = labels[ni];
      if (nlab == QUEUED) continue;
      if (nlab == UNDEF) {
        labels[ni] = QUEUED;
        q.push(QEnt{(double)sal[ni] * sign, e.basin,
                    (int32_t)x, (int32_t)y, (int32_t)z});
        if (vec_std) {
          float *a = vec_std + 3 * at, *b = vec_std + 3 * ni;
          const double d = (double)a[0] * b[0] + (double)a[1] * b[1]
                         + (double)a[2] * b[2];
          if (d < 0.0) { b[0] = -b[0]; b[1] = -b[1]; b[2] = -b[2]; }
        }
      } else {
        const int64_t basin_j = nlab;
        const int64_t ci = basin2cluster[e.basin];
        const int64_t cj = basin2cluster[basin_j];
        bool polarity_match = true;
        if (vec_std) {
          const float *a = vec_std + 3 * at, *b = vec_std + 3 * ni;
          const double d = (double)a[0] * b[0] + (double)a[1] * b[1]
                         + (double)a[2] * b[2];
          if (d * basin2polarity[e.basin] * basin2polarity[basin_j] < 0.0)
            polarity_match = false;
        }
        if (ci == cj) {
          if (!polarity_match) cut_due_to_polarity = true;
        } else {
          const int64_t merged = ci < cj ? ci : cj;
          const int64_t deleted = ci < cj ? cj : ci;
          for (int64_t b : cluster2basins[(size_t)deleted]) {
            cluster2basins[(size_t)merged].push_back(b);
            basin2cluster[b] = merged;
            if (vec_std && !polarity_match)
              basin2polarity[b] = (int8_t)(-basin2polarity[b]);
          }
          cluster2basins[(size_t)deleted].clear();
        }
      }
    }
  }
  return cut_due_to_polarity ? 1 : 0;
}

// Compact-candidate variant of the LabelConnected flood: identical
// semantics, but per-voxel attributes (saliency, discard gate, link
// tensor/vector, standardized vectors) are stored only for CANDIDATE
// voxels -- voxels inside the mask whose saliency passes the flood's
// pop threshold.  Sub-threshold voxels can never spread (they pop
// straight to UNDEF, connect.hpp:520-538), so excluding them up front
// leaves labels/clusters/polarity bit-identical; only their (unused)
// standardized-vector sign flips are skipped.  cand_id: dense int32
// voxel -> candidate index (-1 elsewhere); *_c arrays are indexed by
// candidate id.  labels is dense (int64) as before.
int64_t visfd_connect_flood_compact(
    const int32_t *cand_id,
    const float *sal_c, const uint8_t *discard_c,
    int64_t nz, int64_t ny, int64_t nx,
    const int32_t *seeds_xyz, const float *seed_scores, int64_t n_seeds,
    const int32_t *offs, int64_t n_offs,
    double sign, double threshold_saliency,
    const float *tensor_c, const float *vector_c,
    double threshold_tensor_neighbor, double threshold_vector_neighbor,
    int32_t consider_sign,
    float *vec_std_c,
    int64_t *labels, int64_t *basin2cluster, int8_t *basin2polarity) {
  const int64_t UNDEF = n_seeds + 1;
  const int64_t QUEUED = n_seeds + 2;
  const int64_t n = nz * ny * nx;
  for (int64_t i = 0; i < n; ++i) labels[i] = UNDEF;

  std::vector<std::vector<int64_t>> cluster2basins((size_t)n_seeds);
  for (int64_t i = 0; i < n_seeds; ++i) {
    basin2cluster[i] = i;
    basin2polarity[i] = 1;
    cluster2basins[(size_t)i].push_back(i);
  }

  Heap q;
  for (int64_t i = 0; i < n_seeds; ++i) {
    int32_t ix = seeds_xyz[3 * i], iy = seeds_xyz[3 * i + 1],
            iz = seeds_xyz[3 * i + 2];
    q.push(QEnt{(double)seed_scores[i] * sign, i, ix, iy, iz});
    labels[((int64_t)iz * ny + iy) * nx + ix] = QUEUED;
  }

  bool cut_due_to_polarity = false;

  while (!q.empty()) {
    QEnt e = q.top();
    q.pop();
    const int64_t at = ((int64_t)e.iz * ny + e.iy) * nx + e.ix;
    const int32_t ci = cand_id[at];
    if (e.score > threshold_saliency * sign || ci < 0) {
      labels[at] = UNDEF;
      continue;
    }
    if (discard_c[ci]) {
      labels[at] = UNDEF;
      if (seeds_xyz[3 * e.basin] == e.ix && seeds_xyz[3 * e.basin + 1] == e.iy
          && seeds_xyz[3 * e.basin + 2] == e.iz)
        basin2cluster[e.basin] = -1;
      continue;
    }
    labels[at] = e.basin;

    for (int64_t k = 0; k < n_offs; ++k) {
      const int64_t z = e.iz + offs[3 * k], y = e.iy + offs[3 * k + 1],
                    x = e.ix + offs[3 * k + 2];
      if (!in_bounds(z, y, x, nz, ny, nx)) continue;
      const int64_t ni = (z * ny + y) * nx + x;
      const int32_t cj = cand_id[ni];
      if (cj < 0) continue;

      if (tensor_c) {
        const float *ti = tensor_c + 6 * (int64_t)ci;
        const float *tj = tensor_c + 6 * (int64_t)cj;
        if (trace_product_quirk(ti, tj)
            < threshold_tensor_neighbor * frobenius_quirk(ti)
              * frobenius_quirk(tj))
          continue;
        if (vector_c) {  // tensor without vector: skip the vector gate
          const float *vi = vector_c + 3 * (int64_t)ci;
          const float *vj = vector_c + 3 * (int64_t)cj;
          const double dot = (double)vi[0] * vj[0] + (double)vi[1] * vj[1]
                           + (double)vi[2] * vj[2];
          const double li2 = (double)vi[0] * vi[0] + (double)vi[1] * vi[1]
                           + (double)vi[2] * vi[2];
          const double lj2 = (double)vj[0] * vj[0] + (double)vj[1] * vj[1]
                           + (double)vj[2] * vj[2];
          if (consider_sign) {
            if (dot < threshold_tensor_neighbor * std::sqrt(li2)
                      * std::sqrt(lj2))
              continue;
          } else {
            if (dot * dot < threshold_vector_neighbor
                            * threshold_vector_neighbor * li2 * lj2)
              continue;
          }
        }
      }

      const int64_t nlab = labels[ni];
      if (nlab == QUEUED) continue;
      if (nlab == UNDEF) {
        labels[ni] = QUEUED;
        q.push(QEnt{(double)sal_c[cj] * sign, e.basin,
                    (int32_t)x, (int32_t)y, (int32_t)z});
        if (vec_std_c) {
          float *a = vec_std_c + 3 * (int64_t)ci;
          float *b = vec_std_c + 3 * (int64_t)cj;
          const double d = (double)a[0] * b[0] + (double)a[1] * b[1]
                         + (double)a[2] * b[2];
          if (d < 0.0) { b[0] = -b[0]; b[1] = -b[1]; b[2] = -b[2]; }
        }
      } else {
        const int64_t basin_j = nlab;
        const int64_t cli = basin2cluster[e.basin];
        const int64_t clj = basin2cluster[basin_j];
        bool polarity_match = true;
        if (vec_std_c) {
          const float *a = vec_std_c + 3 * (int64_t)ci;
          const float *b = vec_std_c + 3 * (int64_t)cj;
          const double d = (double)a[0] * b[0] + (double)a[1] * b[1]
                         + (double)a[2] * b[2];
          if (d * basin2polarity[e.basin] * basin2polarity[basin_j] < 0.0)
            polarity_match = false;
        }
        if (cli == clj) {
          if (!polarity_match) cut_due_to_polarity = true;
        } else {
          const int64_t merged = cli < clj ? cli : clj;
          const int64_t deleted = cli < clj ? clj : cli;
          for (int64_t b : cluster2basins[(size_t)deleted]) {
            cluster2basins[(size_t)merged].push_back(b);
            basin2cluster[b] = merged;
            if (vec_std_c && !polarity_match)
              basin2polarity[b] = (int8_t)(-basin2polarity[b]);
          }
          cluster2basins[(size_t)deleted].clear();
        }
      }
    }
  }
  return cut_due_to_polarity ? 1 : 0;
}

// Greedy best-first blob NMS through a coarse occupancy grid
// (DiscardOverlappingBlobs, feature.hpp:720-913), bit-identical to the
// Python version in visfd_tpu.features.blob.discard_overlapping_blobs:
// same double-precision expressions (cubes via pow() to match numpy's
// `** 3`), same grid geometry, same conservative cell-limited
// candidate sets.  Blobs arrive pre-sorted best-first.
//
// crds: (n,3) double (x,y,z); radii/vols: double[n]; grid: (n,3) int64
// cell coords; table_size: int64[3]. keep_out: uint8[n].
// Returns the number of kept blobs.
int64_t visfd_nms(
    const double *crds, const double *radii, const double *vols,
    const int64_t *grid, const int64_t *table_size,
    int64_t n, int64_t scale,
    double sep_ratio, double max_ovl_small, double max_ovl_large,
    uint8_t *keep_out) {
  const int64_t tx = table_size[0], ty = table_size[1], tz = table_size[2];
  // occupancy: hashed bucket table with per-entry exact cell keys and
  // intrusive chaining (no per-cell heap allocations; candidate order
  // within a cell does not affect the boolean discard decision)
  int bucket_bits = 12;
  while (bucket_bits < 24 && ((int64_t)1 << bucket_bits) < 16 * n)
    ++bucket_bits;
  const int64_t n_buckets = (int64_t)1 << bucket_bits;
  std::vector<int32_t> bucket((size_t)n_buckets, -1);
  std::vector<int64_t> entry_key;
  std::vector<int32_t> entry_blob, entry_next;
  auto bucket_of = [&](int64_t key) -> int64_t {
    return (int64_t)(((uint64_t)key * 0x9E3779B97F4A7C15ull)
                     >> (64 - bucket_bits));
  };
  std::vector<int32_t> last_seen((size_t)n, -1);
  std::vector<int64_t> cells;  // flat cell keys covered by blob i
  int64_t n_kept = 0;
  const double third_pi = M_PI / 3.0;

  for (int64_t i = 0; i < n; ++i) {
    keep_out[i] = 0;
    const double ri = radii[i];
    const int64_t big_r = (int64_t)std::ceil(ri / (double)scale) + 1;
    const int64_t gx = grid[3 * i], gy = grid[3 * i + 1],
                  gz = grid[3 * i + 2];
    cells.clear();
    bool discard = false;
    for (int64_t jz = -big_r; jz <= big_r && !discard; ++jz)
      for (int64_t jy = -big_r; jy <= big_r && !discard; ++jy)
        for (int64_t jx = -big_r; jx <= big_r && !discard; ++jx) {
          if (jx * jx + jy * jy + jz * jz > big_r * big_r) continue;
          const int64_t cx = gx + jx, cy = gy + jy, cz = gz + jz;
          if (cx < 0 || cx >= tx || cy < 0 || cy >= ty
              || cz < 0 || cz >= tz)
            continue;
          const int64_t key = cx + tx * (cy + ty * cz);
          cells.push_back(key);
          for (int32_t e = bucket[(size_t)bucket_of(key)]; e >= 0;
               e = entry_next[(size_t)e]) {
            if (entry_key[(size_t)e] != key) continue;
            const int32_t k = entry_blob[(size_t)e];
            if (last_seen[(size_t)k] == (int32_t)i) continue;
            last_seen[(size_t)k] = (int32_t)i;
            const double dx = crds[3 * i] - crds[3 * k];
            const double dy = crds[3 * i + 1] - crds[3 * k + 1];
            const double dz = crds[3 * i + 2] - crds[3 * k + 2];
            const double rik = std::sqrt(dx * dx + dy * dy + dz * dz);
            const double rk = radii[k];
            if (rik < (ri + rk) * sep_ratio) { discard = true; break; }
            // sphere lens overlap (visfd_utils.hpp:93-119); `pow(x, 3)`
            // matches numpy's `x ** 3`
            const double lo = ri < rk ? ri : rk;
            const double hi = ri < rk ? rk : ri;
            double vol;
            if (rik <= lo) {
              vol = (4.0 * M_PI / 3.0) * std::pow(lo, 3.0);
            } else {
              const double xi = 0.5 / rik * (rik * rik + lo * lo - hi * hi);
              const double xj = 0.5 / rik * (rik * rik + hi * hi - lo * lo);
              const double qi = xi / lo, qj = xj / hi;
              vol = third_pi
                  * (std::pow(lo, 3.0) * (2.0 - qi * (3.0 - qi * qi))
                     + std::pow(hi, 3.0) * (2.0 - qj * (3.0 - qj * qj)));
            }
            const double v_small = vols[i] < vols[k] ? vols[i] : vols[k];
            const double v_large = vols[i] < vols[k] ? vols[k] : vols[i];
            if (vol / v_small > max_ovl_small
                || vol / v_large > max_ovl_large) {
              discard = true;
              break;
            }
          }
        }
    if (!discard) {
      keep_out[i] = 1;
      ++n_kept;
      for (int64_t key : cells) {
        const int64_t b = bucket_of(key);
        entry_key.push_back(key);
        entry_blob.push_back((int32_t)i);
        entry_next.push_back(bucket[(size_t)b]);
        bucket[(size_t)b] = (int32_t)(entry_key.size() - 1);
      }
    }
  }
  return n_kept;
}

// The rows of an (n_rows, n_cols) C-contiguous float64 array as text:
// each value as to_chars' general format at 6 significant digits, which
// is printf's %.6g, a space between values and '\n' after each row.
// A NaN prints "nan" whatever its sign bit, as Python's %g does
// (to_chars prints "-nan"); +-inf and -0 already agree.
// out: cap bytes, owned by the caller. Returns the bytes written, or -1
// when they would not fit in cap.
int64_t visfd_format_rows_g6(const double *v, int64_t n_rows,
                             int64_t n_cols, char *out, int64_t cap) {
  char *p = out;
  char *const end = out + cap;
  for (int64_t i = 0; i < n_rows; ++i)
    for (int64_t j = 0; j < n_cols; ++j) {
      const double x = v[i * n_cols + j];
      if (std::isnan(x)) {
        if (end - p < 3) return -1;
        std::memcpy(p, "nan", 3);
        p += 3;
      } else {
        const std::to_chars_result r =
            std::to_chars(p, end, x, std::chars_format::general, 6);
        if (r.ec != std::errc()) return -1;
        p = r.ptr;
      }
      if (p == end) return -1;
      *p++ = j + 1 < n_cols ? ' ' : '\n';
    }
  return p - out;
}

}  // extern "C"
