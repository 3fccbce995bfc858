// Reference-equivalent sequential C++ oracle.
//
// An independent, hash-map-based restatement of the fusion semantics
// (the same contract as oracle.py — voxel occupancy, pre-normal buffering,
// PCA normals over occupied 5x5x5 neighbor centers, +-K dependant lines,
// 1mm cylinder gating with centered-sum statistics). It exists for two
// reasons:
//   1. BASELINE DENOMINATOR: the reference integrates serially in C++
//      (its OMP pragmas are commented out), so a single-threaded C++
//      implementation of the same algorithm is the honest frames/s
//      baseline the TPU pipeline is scored against (BASELINE.md).
//   2. Fast parity oracle for large randomized tests (oracle.py is exact
//      but Python-slow).
//
// Deliberately NOT a copy of the reference: storage is a flat
// unordered_map keyed by dense cell id (no dense 3-D pointer grid, no
// PCL/Eigen/ROS), statistics are commutative centered sums, and the fixes
// documented in oracle.py (validCoord on insert, ghost-dep append) apply.
//
// C ABI for ctypes. Build: `make oracle` in runtime/native.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Vox {
  bool occupied = false;
  bool normal_found = false;
  float normal[3] = {0, 0, 0};
  float viewpoint[3] = {0, 0, 0};
  int64_t count = 0;
  int64_t n_pts = 0;
  double sum_q[3] = {0, 0, 0};
  double sumsq_q[3] = {0, 0, 0};
  double sum_d = 0, sumsq_d = 0;
  std::vector<std::array<float, 3>> buffer;
  std::vector<int64_t> deps;
};

struct Oracle {
  // config
  double bbox[6];
  float res[3];
  float zmin, zmax;
  float cylinder_r, line_step;
  int k, line_k, min_neighbors;
  bool reclaim_buffer = false;
  int64_t dims[3];

  std::unordered_map<int64_t, Vox> map;

  int64_t dim(int a) const {
    return (int64_t)std::floor((bbox[2 * a + 1] - bbox[2 * a]) /
                                   (double)res[a] +
                               1e-9);
  }
  bool valid_point(const float* p) const {
    for (int a = 0; a < 3; ++a)
      if (!(p[a] > bbox[2 * a] && p[a] < bbox[2 * a + 1])) return false;
    return true;
  }
  void coords(const float* p, int64_t* c) const {
    for (int a = 0; a < 3; ++a)
      c[a] = (int64_t)std::floor((p[a] - (float)bbox[2 * a]) / res[a]);
  }
  bool valid_coord(const int64_t* c) const {
    for (int a = 0; a < 3; ++a)
      if (c[a] < 0 || c[a] >= dims[a]) return false;
    return true;
  }
  int64_t cell_id(const int64_t* c) const {
    return (c[0] * dims[1] + c[1]) * dims[2] + c[2];
  }
  void id_coords(int64_t id, int64_t* c) const {
    c[2] = id % dims[2];
    int64_t xy = id / dims[2];
    c[1] = xy % dims[1];
    c[0] = xy / dims[1];
  }
  void center(const int64_t* c, float* out) const {
    for (int a = 0; a < 3; ++a)
      out[a] = (float)bbox[2 * a] + res[a] * ((float)c[a] + 0.5f);
  }

  void accumulate(Vox& owner, int64_t oid, const float* p) {
    int64_t oc[3];
    float ctr[3];
    id_coords(oid, oc);
    center(oc, ctr);
    float q[3] = {p[0] - ctr[0], p[1] - ctr[1], p[2] - ctr[2]};
    const float* n = owner.normal;
    float t = q[0] * n[0] + q[1] * n[1] + q[2] * n[2];
    float qp[3] = {t * n[0], t * n[1], t * n[2]};
    float dx = q[0] - qp[0], dy = q[1] - qp[1], dz = q[2] - qp[2];
    float dist = std::sqrt(dx * dx + dy * dy + dz * dz);
    if (dist < cylinder_r) {
      owner.count++;
      for (int a = 0; a < 3; ++a) {
        owner.sum_q[a] += qp[a];
        owner.sumsq_q[a] += (double)qp[a] * qp[a];
      }
      owner.sum_d += dist;
      owner.sumsq_d += (double)dist * dist;
    }
  }

  void add_frame(const float* pts_cam, int64_t n, const float* pose) {
    const float* R = pose;  // row-major 4x4
    float vp[3] = {pose[3], pose[7], pose[11]};
    for (int64_t i = 0; i < n; ++i) {
      const float* pc = pts_cam + 3 * i;
      if (!(pc[2] > zmin && pc[2] < zmax)) continue;
      float p[3];
      for (int r = 0; r < 3; ++r)
        p[r] = R[4 * r + 0] * pc[0] + R[4 * r + 1] * pc[1] +
               R[4 * r + 2] * pc[2] + R[4 * r + 3];
      if (!valid_point(p)) continue;
      int64_t c[3];
      coords(p, c);
      if (!valid_coord(c)) continue;
      Vox& v = map[cell_id(c)];
      if (!v.occupied) {
        v.occupied = true;
        std::memcpy(v.viewpoint, vp, sizeof vp);
      }
      if (!v.normal_found) v.buffer.push_back({p[0], p[1], p[2]});
      v.n_pts++;
      for (size_t d = 0; d < v.deps.size(); ++d) {
        int64_t oid = v.deps[d];
        accumulate(map[oid], oid, p);
      }
    }
  }

  // closed-form smallest eigenpair of a symmetric 3x3 (Cardano + cross
  // products) — mirrors ops/eigen33.py.
  // f32 line-by-line port of ops/eigen33.py::smallest_eigenpair_sym —
  // the oracle must use the SAME precision and formulas as the device:
  // a double-precision solver perturbs borderline normals by ~1e-7,
  // which shifts the +-K line walk across cell boundaries on ~1% of
  // voxels and changes their dependant links (measured 2849/210066
  // count mismatches at the 1 mm bench config before this port).
  static void smallest_eigvec_f32(float a00, float a01, float a02, float a11,
                                  float a12, float a22, float* out) {
    const float EPS = 1e-20f;
    float scale = std::max(
        std::max(std::max(std::fabs(a00), std::fabs(a11)),
                 std::max(std::fabs(a22), std::fabs(a01))),
        std::max(std::fabs(a02), std::fabs(a12)));
    if (scale < EPS) scale = 1.0f;
    a00 /= scale; a01 /= scale; a02 /= scale;
    a11 /= scale; a12 /= scale; a22 /= scale;

    float p1 = a01 * a01 + a02 * a02 + a12 * a12;
    float q = (a00 + a11 + a22) / 3.0f;
    float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
    float p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0f * p1;
    float p = std::sqrt(std::max(p2 / 6.0f, 0.0f));
    float safe_p = (p < EPS) ? 1.0f : p;
    float detB = (b00 * (b11 * b22 - a12 * a12)
                  - a01 * (a01 * b22 - a12 * a02)
                  + a02 * (a01 * a12 - b11 * a02))
                 / (safe_p * safe_p * safe_p);
    float r = std::min(1.0f, std::max(-1.0f, detB / 2.0f));
    float phi = std::acos(r) / 3.0f;
    float lam = q + 2.0f * p * std::cos(phi + 2.0f * (float)M_PI / 3.0f);
    if (p < EPS) lam = q;

    float m00 = a00 - lam, m11 = a11 - lam, m22 = a22 - lam;
    // rows r0=(m00,a01,a02) r1=(a01,m11,a12) r2=(a02,a12,m22)
    auto cross = [](float ax, float ay, float az, float bx, float by,
                    float bz, float* c) {
      c[0] = ay * bz - az * by;
      c[1] = az * bx - ax * bz;
      c[2] = ax * by - ay * bx;
    };
    float c01[3], c02[3], c12[3];
    cross(m00, a01, a02, a01, m11, a12, c01);
    cross(m00, a01, a02, a02, a12, m22, c02);
    cross(a01, m11, a12, a02, a12, m22, c12);
    auto sq = [](const float* c) {
      return c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    };
    float n01 = sq(c01), n02 = sq(c02), n12 = sq(c12);
    bool best12 = n12 > std::max(n01, n02);
    bool best02 = (n02 >= n12) && (n02 > n01);
    const float* v = best12 ? c12 : (best02 ? c02 : c01);
    float nrm2 = std::max(sq(v), 0.0f);
    float nrm = std::sqrt(nrm2);
    bool ok = nrm > 1e-12f;
    float inv = ok ? 1.0f / ((nrm < 1e-30f) ? 1.0f : nrm) : 0.0f;
    if (ok) {
      out[0] = v[0] * inv;
      out[1] = v[1] * inv;
      out[2] = v[2] * inv;
    } else {
      float d0 = std::fabs(m00), d1 = std::fabs(m11), d2 = std::fabs(m22);
      bool f0 = (d0 <= d1) && (d0 <= d2);
      bool f1 = !f0 && (d1 <= d2);
      out[0] = f0 ? 1.0f : 0.0f;
      out[1] = f1 ? 1.0f : 0.0f;
      out[2] = (!f0 && !f1) ? 1.0f : 0.0f;
    }
  }

  static void smallest_eigvec(const double A[3][3], float* out) {
    double scale = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) scale = std::max(scale, std::fabs(A[i][j]));
    if (scale < 1e-30) scale = 1.0;
    double a00 = A[0][0] / scale, a01 = A[0][1] / scale,
           a02 = A[0][2] / scale, a11 = A[1][1] / scale,
           a12 = A[1][2] / scale, a22 = A[2][2] / scale;
    double p1 = a01 * a01 + a02 * a02 + a12 * a12;
    double q = (a00 + a11 + a22) / 3.0;
    double b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
    double p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1;
    double p = std::sqrt(std::max(p2 / 6.0, 0.0));
    double lam;
    if (p < 1e-20) {
      lam = q;
    } else {
      double det = (b00 * (b11 * b22 - a12 * a12) -
                    a01 * (a01 * b22 - a12 * a02) +
                    a02 * (a01 * a12 - b11 * a02)) /
                   (p * p * p);
      double r = std::min(1.0, std::max(-1.0, det / 2.0));
      double phi = std::acos(r) / 3.0;
      lam = q + 2.0 * p * std::cos(phi + 2.0 * M_PI / 3.0);
    }
    double M[3][3] = {{a00 - lam, a01, a02},
                      {a01, a11 - lam, a12},
                      {a02, a12, a22 - lam}};
    double best[3] = {0, 0, 0}, bestn = -1;
    int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    for (auto& pr : pairs) {
      const double* r0 = M[pr[0]];
      const double* r1 = M[pr[1]];
      double cx = r0[1] * r1[2] - r0[2] * r1[1];
      double cy = r0[2] * r1[0] - r0[0] * r1[2];
      double cz = r0[0] * r1[1] - r0[1] * r1[0];
      double nn = cx * cx + cy * cy + cz * cz;
      if (nn > bestn) {
        bestn = nn;
        best[0] = cx;
        best[1] = cy;
        best[2] = cz;
      }
    }
    double nrm = std::sqrt(bestn);
    if (nrm < 1e-12) {  // degenerate: smallest-diagonal axis
      int a = 0;
      for (int i = 1; i < 3; ++i)
        if (std::fabs(M[i][i]) < std::fabs(M[a][a])) a = i;
      out[0] = out[1] = out[2] = 0;
      out[a] = 1;
      return;
    }
    for (int a = 0; a < 3; ++a) out[a] = (float)(best[a] / nrm);
  }

  void refine() {
    std::vector<int64_t> cands;
    for (auto& kv : map)
      if (kv.second.occupied && !kv.second.normal_found)
        cands.push_back(kv.first);
    for (int64_t cid : cands) {
      Vox& v = map[cid];
      int64_t c[3];
      id_coords(cid, c);
      // occupied neighbors in the (2k+1)^3 window
      std::vector<std::array<int, 3>> occ;
      for (int dx = -k; dx <= k; ++dx)
        for (int dy = -k; dy <= k; ++dy)
          for (int dz = -k; dz <= k; ++dz) {
            int64_t nc[3] = {c[0] + dx, c[1] + dy, c[2] + dz};
            if (!valid_coord(nc)) continue;
            auto it = map.find(cell_id(nc));
            if (it != map.end() && it->second.occupied)
              occ.push_back({dx, dy, dz});
          }
      if ((int)occ.size() < min_neighbors) continue;
      // PCA over occupied neighbor centers in offset space, f32
      // moment-form — the same accumulation the device uses
      // (ops/refine.py moments matmul + centered subtraction)
      float mx = 0, my = 0, mz = 0;
      float sxx = 0, sxy = 0, sxz = 0, syy = 0, syz = 0, szz = 0;
      for (auto& o : occ) {
        float ox = o[0] * res[0], oy = o[1] * res[1], oz = o[2] * res[2];
        mx += ox; my += oy; mz += oz;
        sxx += ox * ox; sxy += ox * oy; sxz += ox * oz;
        syy += oy * oy; syz += oy * oz; szz += oz * oz;
      }
      float tot = std::max((float)occ.size(), 1.0f);
      mx /= tot; my /= tot; mz /= tot;
      float n[3];
      smallest_eigvec_f32(sxx / tot - mx * mx, sxy / tot - mx * my,
                          sxz / tot - mx * mz, syy / tot - my * my,
                          syz / tot - my * mz, szz / tot - mz * mz, n);
      float ctr[3];
      center(c, ctr);
      float dir[3] = {v.viewpoint[0] - ctr[0], v.viewpoint[1] - ctr[1],
                      v.viewpoint[2] - ctr[2]};
      if (dir[0] * n[0] + dir[1] * n[1] + dir[2] * n[2] < 0)
        for (int a = 0; a < 3; ++a) n[a] = -n[a];
      std::memcpy(v.normal, n, sizeof n);
      v.normal_found = true;
      for (int i = -line_k; i <= line_k; ++i) {
        float pos[3] = {ctr[0] + i * line_step * n[0],
                        ctr[1] + i * line_step * n[1],
                        ctr[2] + i * line_step * n[2]};
        if (!valid_point(pos)) continue;
        int64_t lc[3];
        coords(pos, lc);
        if (!valid_coord(lc)) continue;
        int64_t lid = cell_id(lc);
        Vox& lv = map[lid];  // creates ghost if absent (occupied=false)
        lv.deps.push_back(cid);
        if (lv.occupied) {
          Vox& self = map[cid];
          for (auto& bp : lv.buffer) accumulate(self, cid, bp.data());
        }
      }
    }
    if (reclaim_buffer) {
      // mirror of the device's post-pass reclamation (ops/refine.py):
      // frozen buffers of normal-found voxels are dropped
      for (auto& kv : map)
        if (kv.second.normal_found && !kv.second.buffer.empty()) {
          kv.second.buffer.clear();
          kv.second.buffer.shrink_to_fit();
        }
    }
  }

  int64_t extract(float* out_centroid, float* out_normal, double* out_sd,
                  double* out_dist, int64_t* out_count, int64_t* out_cell,
                  int64_t cap) {
    std::vector<int64_t> ids;
    ids.reserve(map.size());
    for (auto& kv : map)
      if (kv.second.occupied && kv.second.normal_found)
        ids.push_back(kv.first);
    std::sort(ids.begin(), ids.end());
    int64_t n = 0;
    for (int64_t id : ids) {
      if (n >= cap) break;
      Vox& v = map[id];
      int64_t c[3];
      float ctr[3];
      id_coords(id, c);
      center(c, ctr);
      if (out_cell) out_cell[n] = id;
      if (out_count) out_count[n] = v.count;
      for (int a = 0; a < 3; ++a) {
        double m = v.count ? v.sum_q[a] / v.count : 0.0;
        if (out_centroid)
          out_centroid[3 * n + a] = v.count ? (float)(ctr[a] + m) : 0.f;
        if (out_normal) out_normal[3 * n + a] = v.normal[a];
        if (out_sd)
          out_sd[3 * n + a] = v.count ? v.sumsq_q[a] / v.count - m * m : 0.0;
      }
      if (out_dist) {
        double md = v.count ? v.sum_d / v.count : 0.0;
        out_dist[2 * n + 0] = md;
        out_dist[2 * n + 1] =
            v.count ? v.sumsq_d / v.count - md * md : 0.0;
      }
      ++n;
    }
    return n;
  }
};

// ---------------------------------------------------------------------
// TSDF variant oracle (BASELINE config 5 denominator; PERF.md §12).
//
// Single-threaded restatement of the TSDF band-integration semantics
// (models/tsdf.py, oracle/tsdf_oracle.py): per valid camera point, S
// samples at centered-integer offsets spanning [-tau, tau] along the
// unit viewpoint->point ray; each in-bounds sample's voxel accumulates
// (w += 1, wsdf += -s).  Surface extraction keeps voxels with
// w >= min_weight and |wsdf/w| < band * res_x.  Color accumulation is
// omitted — the flagship baseline (Oracle::add_frame above) also times
// the geometry path with rgb dropped, so the two denominators price the
// same work.  f32 arithmetic in the device kernel's operation order.
struct TsdfCell {
  float w = 0.0f, wsdf = 0.0f;
};

struct TsdfOracleN {
  double bbox[6];
  float res[3];
  float zmin, zmax, trunc;
  int n_samples;
  int64_t dims[3];
  std::unordered_map<int64_t, TsdfCell> map;

  void add_frame(const float* pts, int64_t n, const float* pose) {
    const int S = n_samples;
    const float step = (float)(2.0 * (double)trunc / (double)(S - 1));
    std::vector<float> svals((size_t)S);
    for (int j = 0; j < S; ++j)
      svals[(size_t)j] = ((float)j - (float)((S - 1) / 2.0)) * step;
    const float ox = (float)bbox[0], oy = (float)bbox[2],
                oz = (float)bbox[4];
    for (int64_t i = 0; i < n; ++i) {
      const float* p = pts + 3 * i;
      if (!(p[2] > zmin && p[2] < zmax)) continue;
      float w[3];
      for (int a = 0; a < 3; ++a)
        w[a] = pose[4 * a] * p[0] + pose[4 * a + 1] * p[1] +
               pose[4 * a + 2] * p[2] + pose[4 * a + 3];
      const float rx = w[0] - pose[3], ry = w[1] - pose[7],
                  rz = w[2] - pose[11];
      const float dist = std::sqrt(rx * rx + ry * ry + rz * rz);
      const float inv = 1.0f / std::max(dist, 1e-6f);
      const float d0 = rx * inv, d1 = ry * inv, d2 = rz * inv;
      for (int j = 0; j < S; ++j) {
        const float s = svals[(size_t)j];
        const float px = w[0] + s * d0, py = w[1] + s * d1,
                    pz = w[2] + s * d2;
        if (!(px > bbox[0] && px < bbox[1] && py > bbox[2] &&
              py < bbox[3] && pz > bbox[4] && pz < bbox[5]))
          continue;
        const int64_t cx = (int64_t)std::floor((px - ox) / res[0]);
        const int64_t cy = (int64_t)std::floor((py - oy) / res[1]);
        const int64_t cz = (int64_t)std::floor((pz - oz) / res[2]);
        if (cx < 0 || cx >= dims[0] || cy < 0 || cy >= dims[1] ||
            cz < 0 || cz >= dims[2])
          continue;
        TsdfCell& c = map[(cx * dims[1] + cy) * dims[2] + cz];
        c.w += 1.0f;
        c.wsdf += -s;
      }
    }
  }

  int64_t extract(float min_weight, float band, int64_t* cell,
                  float* tsdf, float* weight, int64_t cap) const {
    std::vector<int64_t> keys;
    keys.reserve(map.size());
    for (const auto& kv : map) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());
    const float thr = band * res[0];
    int64_t m = 0;
    for (int64_t cid : keys) {
      const TsdfCell& c = map.at(cid);
      if (c.w <= 0.0f) continue;
      const float t = c.wsdf / std::max(c.w, 1e-9f);
      if (c.w < min_weight || std::fabs(t) >= thr) continue;
      if (cell != nullptr && m < cap) {
        cell[m] = cid;
        tsdf[m] = t;
        weight[m] = c.w;
      }
      ++m;
    }
    return m;
  }
};

}  // namespace

extern "C" {

void* hf_tsdf_create(const double* bbox, const float* res, float zmin,
                     float zmax, float trunc, int n_samples,
                     const int64_t* dims) {
  TsdfOracleN* o = new TsdfOracleN();
  std::memcpy(o->bbox, bbox, 6 * sizeof(double));
  std::memcpy(o->res, res, 3 * sizeof(float));
  o->zmin = zmin;
  o->zmax = zmax;
  o->trunc = trunc;
  o->n_samples = n_samples;
  for (int a = 0; a < 3; ++a) o->dims[a] = dims[a];
  return o;
}

void hf_tsdf_add_frame(void* h, const float* pts_cam, int64_t n,
                       const float* pose) {
  static_cast<TsdfOracleN*>(h)->add_frame(pts_cam, n, pose);
}

int64_t hf_tsdf_extract(void* h, float min_weight, float band,
                        int64_t* cell, float* tsdf, float* weight,
                        int64_t cap) {
  return static_cast<TsdfOracleN*>(h)->extract(min_weight, band, cell,
                                               tsdf, weight, cap);
}

int64_t hf_tsdf_n_cells(void* h) {
  return (int64_t)static_cast<TsdfOracleN*>(h)->map.size();
}

void hf_tsdf_destroy(void* h) { delete static_cast<TsdfOracleN*>(h); }

void* hf_oracle_create(const double* bbox, const float* res, float zmin,
                       float zmax, float cylinder_r, int k, int line_k,
                       int min_neighbors, const int64_t* dims) {
  Oracle* o = new Oracle();
  std::memcpy(o->bbox, bbox, 6 * sizeof(double));
  std::memcpy(o->res, res, 3 * sizeof(float));
  o->zmin = zmin;
  o->zmax = zmax;
  o->cylinder_r = cylinder_r;
  o->line_step = res[0];  // the reference steps lines by xres only
  o->k = k;
  o->line_k = line_k;
  o->min_neighbors = min_neighbors;
  // dims come from FusionConfig (authoritative): recomputing them here
  // from the f32 resolution truncates differently (0.7/0.001f -> 699)
  // and shifts every dense cell id against the device pipeline
  for (int a = 0; a < 3; ++a) o->dims[a] = dims ? dims[a] : o->dim(a);
  return o;
}

void hf_oracle_set_reclaim(void* h, int on) {
  static_cast<Oracle*>(h)->reclaim_buffer = on != 0;
}

void hf_oracle_add_frame(void* h, const float* pts_cam, int64_t n,
                         const float* pose) {
  static_cast<Oracle*>(h)->add_frame(pts_cam, n, pose);
}

void hf_oracle_refine(void* h) { static_cast<Oracle*>(h)->refine(); }

int64_t hf_oracle_extract(void* h, float* centroid, float* normal,
                          double* sd, double* dist, int64_t* count,
                          int64_t* cell, int64_t cap) {
  return static_cast<Oracle*>(h)->extract(centroid, normal, sd, dist, count,
                                          cell, cap);
}

int64_t hf_oracle_n_voxels(void* h) {
  return (int64_t)static_cast<Oracle*>(h)->map.size();
}

void hf_oracle_destroy(void* h) { delete static_cast<Oracle*>(h); }

}  // extern "C"
