// hommx_tpu_torch native host runtime (a copy of hommx_tpu/native/hostruntime.cpp).
//
// The port's compute path is PyTorch with hand-written CUDA kernels; this
// file is the native runtime *around* it: the host-side setup hot paths
// that the reference delegates to DOLFINx's C++ core (mesh topology/dofmap
// construction, reference hmm.py:124,307-317; boundary entity location;
// dolfinx_mpc's periodic constraint search, cell_problem.py:16-300) and to
// create_interpolation_data/interpolate_nonmatching (point→cell search).
// The algorithms are those of the JAX package's copy, so that both give the
// same outputs bit for bit.
//
// Exposed as a plain C ABI consumed via ctypes; every entry point has a
// numpy version in the Python layer, so the library is an accelerator, not
// a hard dependency.
//
// Build (hommx_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 hostruntime.cpp -o libhostruntime-<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// ELL sparsity pattern construction (replaces the np.unique path in
// ops/sparse.py::build_ell_pattern; O(nnz·K) with small-K linear probing).
// ---------------------------------------------------------------------------

// Phase 1: distinct-neighbor count per row; returns max row width K (or -1).
int64_t hr_ell_width(const int32_t* cells, int64_t nc, int32_t nb,
                     int64_t ndofs, int32_t* row_counts /* ndofs, out */) {
  std::vector<std::vector<int32_t>> adj(ndofs);
  for (int64_t r = 0; r < ndofs; ++r) adj[r].reserve(16);
  for (int64_t c = 0; c < nc; ++c) {
    const int32_t* cd = cells + c * nb;
    for (int32_t a = 0; a < nb; ++a) {
      int32_t row = cd[a];
      if (row < 0 || row >= ndofs) return -1;
      auto& nbrs = adj[row];
      for (int32_t b = 0; b < nb; ++b) {
        int32_t col = cd[b];
        bool found = false;
        for (int32_t x : nbrs)
          if (x == col) { found = true; break; }
        if (!found) nbrs.push_back(col);
      }
    }
  }
  int64_t K = 0;
  for (int64_t r = 0; r < ndofs; ++r) {
    row_counts[r] = (int32_t)adj[r].size();
    if ((int64_t)adj[r].size() > K) K = adj[r].size();
  }
  return K;
}

// Phase 2: fill cols (ndofs*K), slots (nc*nb*nb) and diag (ndofs).
int32_t hr_ell_fill(const int32_t* cells, int64_t nc, int32_t nb,
                    int64_t ndofs, int64_t K, int32_t* cols, int32_t* slots,
                    int32_t* diag) {
  std::vector<std::vector<int32_t>> adj(ndofs);
  for (int64_t r = 0; r < ndofs; ++r) adj[r].reserve(16);
  for (int64_t c = 0; c < nc; ++c) {
    const int32_t* cd = cells + c * nb;
    for (int32_t a = 0; a < nb; ++a) {
      auto& nbrs = adj[cd[a]];
      for (int32_t b = 0; b < nb; ++b) {
        int32_t col = cd[b];
        bool found = false;
        for (int32_t x : nbrs)
          if (x == col) { found = true; break; }
        if (!found) nbrs.push_back(col);
      }
    }
  }
  std::memset(cols, 0, sizeof(int32_t) * (size_t)(ndofs * K));
  for (int64_t r = 0; r < ndofs; ++r) {
    auto& nbrs = adj[r];
    std::sort(nbrs.begin(), nbrs.end());
    for (size_t k = 0; k < nbrs.size(); ++k) cols[r * K + k] = nbrs[k];
    auto it = std::lower_bound(nbrs.begin(), nbrs.end(), (int32_t)r);
    diag[r] = (int32_t)(r * K + (it - nbrs.begin()));
  }
  for (int64_t c = 0; c < nc; ++c) {
    const int32_t* cd = cells + c * nb;
    for (int32_t a = 0; a < nb; ++a) {
      int32_t row = cd[a];
      const auto& nbrs = adj[row];
      for (int32_t b = 0; b < nb; ++b) {
        auto it = std::lower_bound(nbrs.begin(), nbrs.end(), cd[b]);
        slots[(c * nb + a) * nb + b] =
            (int32_t)(row * K + (it - nbrs.begin()));
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Periodic slave→master vertex matching on a box mesh (replaces the Python
// dict lookup in micro/periodic.py; hash map on quantized coordinates).
// ---------------------------------------------------------------------------

static inline int64_t quantize(double v, double lo, double scale) {
  return (int64_t)llround((v - lo) / scale * 1e12);
}

struct KeyHash {
  size_t operator()(const std::vector<int64_t>& k) const {
    size_t h = 1469598103934665603ull;
    for (int64_t v : k) {
      h ^= (size_t)v;
      h *= 1099511628211ull;
    }
    return h;
  }
};

// masters[v] = index of the master vertex; is_slave as int8. Returns number
// of unmatched slaves (0 = success).
int64_t hr_periodic_match(const double* verts, int64_t nv, int32_t dim,
                          double rtol, double atol, int64_t* masters,
                          int8_t* is_slave) {
  std::vector<double> lo(dim, 1e300), hi(dim, -1e300);
  for (int64_t v = 0; v < nv; ++v)
    for (int32_t k = 0; k < dim; ++k) {
      double x = verts[v * dim + k];
      lo[k] = std::min(lo[k], x);
      hi[k] = std::max(hi[k], x);
    }
  std::vector<double> scale(dim);
  for (int32_t k = 0; k < dim; ++k)
    scale[k] = (hi[k] - lo[k]) > 0 ? (hi[k] - lo[k]) : 1.0;

  std::unordered_map<std::vector<int64_t>, int64_t, KeyHash> lookup;
  lookup.reserve((size_t)nv * 2);
  std::vector<int64_t> key(dim);
  for (int64_t v = 0; v < nv; ++v) {
    for (int32_t k = 0; k < dim; ++k)
      key[k] = quantize(verts[v * dim + k], lo[k], scale[k]);
    lookup.emplace(key, v);
  }

  int64_t unmatched = 0;
  for (int64_t v = 0; v < nv; ++v) {
    bool slave = false;
    for (int32_t k = 0; k < dim; ++k) {
      double x = verts[v * dim + k];
      double tol = atol + rtol * std::fabs(hi[k]);
      double target = (std::fabs(x - hi[k]) <= tol) ? lo[k] : x;
      if (target != x) slave = true;
      key[k] = quantize(target, lo[k], scale[k]);
    }
    is_slave[v] = slave ? 1 : 0;
    if (!slave) {
      masters[v] = v;
      continue;
    }
    auto it = lookup.find(key);
    if (it == lookup.end()) {
      masters[v] = -1;
      ++unmatched;
    } else {
      masters[v] = it->second;
    }
  }
  return unmatched;
}

// ---------------------------------------------------------------------------
// Binned point→cell location for unstructured simplex meshes (replaces the
// Python bucket loop in ops/interpolation.py::_locate_binned).
// ---------------------------------------------------------------------------

static bool barycentric_inside(const double* vp, const int32_t* cell,
                               int32_t dim, const double* p, double tol,
                               double* viol_out) {
  double T[9], rhs[3], xi[3];
  const double* p0 = vp + (int64_t)cell[0] * dim;
  for (int32_t j = 0; j < dim; ++j) {
    const double* pj = vp + (int64_t)cell[j + 1] * dim;
    for (int32_t i = 0; i < dim; ++i) T[i * dim + j] = pj[i] - p0[i];
    rhs[j] = 0.0;
  }
  for (int32_t i = 0; i < dim; ++i) rhs[i] = p[i] - p0[i];
  // solve T xi = rhs (tiny Gaussian elimination with partial pivoting)
  int32_t piv[3] = {0, 1, 2};
  for (int32_t c = 0; c < dim; ++c) {
    int32_t best = c;
    for (int32_t r = c + 1; r < dim; ++r)
      if (std::fabs(T[r * dim + c]) > std::fabs(T[best * dim + c])) best = r;
    if (best != c) {
      for (int32_t j = 0; j < dim; ++j) std::swap(T[c * dim + j], T[best * dim + j]);
      std::swap(rhs[c], rhs[best]);
      std::swap(piv[c], piv[best]);
    }
    double d = T[c * dim + c];
    if (d == 0.0) { *viol_out = 1e300; return false; }
    for (int32_t r = c + 1; r < dim; ++r) {
      double f = T[r * dim + c] / d;
      for (int32_t j = c; j < dim; ++j) T[r * dim + j] -= f * T[c * dim + j];
      rhs[r] -= f * rhs[c];
    }
  }
  for (int32_t r = dim - 1; r >= 0; --r) {
    double s = rhs[r];
    for (int32_t j = r + 1; j < dim; ++j) s -= T[r * dim + j] * xi[j];
    xi[r] = s / T[r * dim + r];
  }
  double lam0 = 1.0;
  double minl = 1e300;
  for (int32_t j = 0; j < dim; ++j) {
    lam0 -= xi[j];
    minl = std::min(minl, xi[j]);
  }
  minl = std::min(minl, lam0);
  *viol_out = minl < 0 ? -minl : 0.0;
  return minl > -tol;
}

int32_t hr_locate_cells(const double* verts, int64_t nv, const int32_t* cells,
                        int64_t nc, int32_t dim, const double* points,
                        int64_t np_, int32_t* out) {
  int32_t nb = dim + 1;
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t v = 0; v < nv; ++v)
    for (int32_t k = 0; k < dim; ++k) {
      lo[k] = std::min(lo[k], verts[v * dim + k]);
      hi[k] = std::max(hi[k], verts[v * dim + k]);
    }
  int64_t nbins = std::max<int64_t>(1, (int64_t)std::floor(
      std::pow((double)nc / 2.0, 1.0 / dim)));
  double span[3];
  for (int32_t k = 0; k < dim; ++k)
    span[k] = (hi[k] - lo[k]) > 0 ? (hi[k] - lo[k]) : 1.0;

  auto bin_of = [&](double x, int32_t k) {
    int64_t b = (int64_t)((x - lo[k]) / span[k] * nbins);
    return std::min(std::max<int64_t>(b, 0), nbins - 1);
  };
  // bucket cells by bbox
  int64_t total_bins = 1;
  for (int32_t k = 0; k < dim; ++k) total_bins *= nbins;
  std::vector<std::vector<int32_t>> buckets(total_bins);
  for (int64_t c = 0; c < nc; ++c) {
    int64_t bmin[3], bmax[3];
    for (int32_t k = 0; k < dim; ++k) {
      double cmin = 1e300, cmax = -1e300;
      for (int32_t a = 0; a < nb; ++a) {
        double x = verts[(int64_t)cells[c * nb + a] * dim + k];
        cmin = std::min(cmin, x);
        cmax = std::max(cmax, x);
      }
      bmin[k] = bin_of(cmin, k);
      bmax[k] = bin_of(cmax, k);
    }
    int64_t iz0 = (dim == 3) ? bmin[2] : 0, iz1 = (dim == 3) ? bmax[2] : 0;
    for (int64_t ix = bmin[0]; ix <= bmax[0]; ++ix)
      for (int64_t iy = bmin[1]; iy <= bmax[1]; ++iy)
        for (int64_t iz = iz0; iz <= iz1; ++iz) {
          int64_t key = (ix * nbins + iy) * (dim == 3 ? nbins : 1) + iz;
          buckets[key].push_back((int32_t)c);
        }
  }
  for (int64_t p = 0; p < np_; ++p) {
    const double* pt = points + p * dim;
    int64_t ix = bin_of(pt[0], 0), iy = bin_of(pt[1], 1);
    int64_t iz = (dim == 3) ? bin_of(pt[2], 2) : 0;
    int64_t key = (ix * nbins + iy) * (dim == 3 ? nbins : 1) + iz;
    const auto& cand = buckets[key];
    int32_t best = 0;
    double best_viol = 1e300;
    auto consider = [&](int32_t c) {
      double viol;
      barycentric_inside(verts, cells + (int64_t)c * nb, dim, pt, 1e-12, &viol);
      if (viol < best_viol) {
        best_viol = viol;
        best = c;
      }
    };
    for (int32_t c : cand) {
      consider(c);
      if (best_viol <= 1e-12) break;
    }
    if (best_viol > 1e-9) {  // fall back to exhaustive scan (rare)
      for (int64_t c = 0; c < nc; ++c) {
        consider((int32_t)c);
        if (best_viol <= 1e-12) break;
      }
    }
    out[p] = best;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy plain aggregation for the AMG setup (replaces the Python node loop
// in ops/amg.py::_greedy_aggregate; identical aggregation: every
// unaggregated node in index order seeds an aggregate of itself + its
// unaggregated neighbours).  Input: node adjacency as COO sorted by row.
// Returns the number of aggregates (or -1 on bad input).
// ---------------------------------------------------------------------------

int64_t hr_greedy_aggregate(const int64_t* rows_sorted,
                            const int64_t* cols_sorted, int64_t nnz,
                            int64_t n_nodes, int64_t* agg /* n_nodes, out */) {
  std::vector<int64_t> starts(n_nodes + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t r = rows_sorted[e];
    if (r < 0 || r >= n_nodes) return -1;
    if (e > 0 && rows_sorted[e - 1] > r) return -1;  // must be sorted
    starts[r + 1]++;
  }
  for (int64_t r = 0; r < n_nodes; ++r) starts[r + 1] += starts[r];
  for (int64_t v = 0; v < n_nodes; ++v) agg[v] = -1;
  int64_t na = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    if (agg[i] >= 0) continue;
    agg[i] = na;
    for (int64_t e = starts[i]; e < starts[i + 1]; ++e) {
      int64_t j = cols_sorted[e];
      if (j >= 0 && j < n_nodes && agg[j] < 0) agg[j] = na;
    }
    ++na;
  }
  return na;
}

}  // extern "C"
