// Kernel K4: the refine pass's normal fit, one thread per candidate.
//
// Replaces: the candidate fit of refine_pass_impl in
// hifi_fusion_tpu/ops/refine.py (:171-260): the (2k+1)^3 occupancy window
// read from the cell-id-keyed bitmap with two words per (dx,dy) column
// (:184-219), the "total >= min_neighbors" gate (:222), the offset-space
// moments, which the JAX package forms as one (9,125)x(125,U) matrix
// product (:229-245), the closed-form smallest eigenpair
// (hifi_fusion_tpu/ops/eigen33.py:27-105), and the orientation toward
// the stored viewpoint (:252-254).
//
// Bound on the card: scattered loads.  A candidate reads 2 bitmap words
// per column (50 for k=2) from a 24.5 MB bitmap at the bench size, which
// fits in the 50 MB L2, plus its key and viewpoint; ~1.3 k flops of
// moments and ~100 of eigen math.  At U <= 2^18 candidates that is ~13 M
// scattered 4 B reads and ~0.4 Gflop: latency-bound, not compute-bound.
//
// Design: the thread keeps the 9 moments in registers and walks the
// window in (dx, dy, dz) order.  The plain version (ops/refine.py
// normal_fit_plain) sums the moments in the same order and performs the
// same f32 operations in the same order (the library is built with
// -fmad=false), so the gate count is exact and the normals agree closely;
// that matters because a window whose two smallest eigenvalues nearly
// coincide has an ill-conditioned normal, where any change of rounding
// turns the normal by up to ~1e-3.  Gated candidates write normal and
// normal_found in place; every candidate also writes its oriented normal
// and gate to nvec / gated, which the line-cell stage reads.

#include "common.cuh"

// f32 constants, bit-identical to the plain version's
#define EPS20 0x1.79ca1p-67f        // 1e-20
#define TWO_PI_3 0x1.0c1524p+1f    // 2*pi/3
#define EPS12 0x1.197998p-40f      // 1e-12

__device__ void eigenvector_sym(float a00, float a01, float a02, float a11,
                                float a12, float a22, float lam, float* v) {
    const float m00 = a00 - lam, m11 = a11 - lam, m22 = a22 - lam;
    // rows r0 = (m00, a01, a02), r1 = (a01, m11, a12), r2 = (a02, a12, m22)
    const float c01[3] = {a01 * a12 - a02 * m11, a02 * a01 - m00 * a12,
                          m00 * m11 - a01 * a01};
    const float c02[3] = {a01 * m22 - a02 * a12, a02 * a02 - m00 * m22,
                          m00 * a12 - a01 * a02};
    const float c12[3] = {m11 * m22 - a12 * a12, a12 * a02 - a01 * m22,
                          a01 * a12 - m11 * a02};
    const float n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2];
    const float n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2];
    const float n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2];
    const bool best12 = n12 > fmaxf(n01, n02);
    const bool best02 = (n02 >= n12) && (n02 > n01);
    const float* c = best12 ? c12 : (best02 ? c02 : c01);
    const float nrm = sqrtf(fmaxf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2],
                                  0.0f));
    if (nrm > EPS12) {
        const float inv = 1.0f / nrm;
        for (int a = 0; a < 3; ++a) v[a] = c[a] * inv;
        return;
    }
    const float d0 = fabsf(m00), d1 = fabsf(m11), d2 = fabsf(m22);
    const bool f0 = (d0 <= d1) && (d0 <= d2);
    const bool f1 = !f0 && (d1 <= d2);
    v[0] = f0 ? 1.0f : 0.0f;
    v[1] = f1 ? 1.0f : 0.0f;
    v[2] = (!f0 && !f1) ? 1.0f : 0.0f;
}

// hifi_fusion_tpu/ops/eigen33.py smallest_eigenpair_sym, one matrix
__device__ void smallest_eigvec_sym(float a00, float a01, float a02,
                                    float a11, float a12, float a22,
                                    float* v) {
    float scale = fmaxf(fmaxf(fmaxf(fabsf(a00), fabsf(a11)),
                              fmaxf(fabsf(a22), fabsf(a01))),
                        fmaxf(fabsf(a02), fabsf(a12)));
    if (scale < EPS20) scale = 1.0f;
    a00 /= scale; a01 /= scale; a02 /= scale;
    a11 /= scale; a12 /= scale; a22 /= scale;
    const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
    const float q = (a00 + a11 + a22) / 3.0f;
    const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
    const float p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0f * p1;
    const float p = sqrtf(fmaxf(p2 / 6.0f, 0.0f));
    const float sp = p < EPS20 ? 1.0f : p;
    const float detB = (b00 * (b11 * b22 - a12 * a12)
                        - a01 * (a01 * b22 - a12 * a02)
                        + a02 * (a01 * a12 - b11 * a02)) / (sp * sp * sp);
    const float r = fminf(fmaxf(detB / 2.0f, -1.0f), 1.0f);
    const float phi = acosf(r) / 3.0f;
    float lam = q + 2.0f * p * cosf(phi + TWO_PI_3);
    if (p < EPS20) lam = q;
    eigenvector_sym(a00, a01, a02, a11, a12, a22, lam, v);
}

__global__ void normal_fit_kernel(
    const int* __restrict__ cand, int U, const int* __restrict__ key,
    const int* __restrict__ occ_bits, int W,
    const float* __restrict__ viewpoint, Geo g, int k, int min_nb,
    float* __restrict__ nvec, unsigned char* __restrict__ gated,
    float* __restrict__ normal, unsigned char* __restrict__ normal_found) {
    int u = blockIdx.x * blockDim.x + threadIdx.x;
    if (u >= U) return;
    const int s = cand[u];
    const int id = key[s];
    const int cz = id % g.dims[2];
    const int cy = (id / g.dims[2]) % g.dims[1];
    const int cx = (id / g.dims[2]) / g.dims[1];

    int total = 0;
    float m[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int dx = -k; dx <= k; ++dx) {
        for (int dy = -k; dy <= k; ++dy) {
            const int nx = cx + dx, ny = cy + dy;
            if (nx < 0 || nx >= g.dims[0] || ny < 0 || ny >= g.dims[1])
                continue;
            // the column's 2k+1 z bits lie in at most two adjacent words
            const int colbase = (nx * g.dims[1] + ny) * g.dims[2] + cz;
            const int shpos = max(colbase - k, 0);
            const int w0i = min(shpos >> 5, W - 1);
            const uint32_t w0 = (uint32_t)occ_bits[w0i];
            const uint32_t w1 =
                w0i + 1 < W ? (uint32_t)occ_bits[w0i + 1] : 0u;
            const uint32_t b0 = (uint32_t)(shpos & 31);
            const uint32_t win = (w0 >> b0) | (b0 > 0 ? w1 << (32 - b0) : 0u);
            for (int dz = -k; dz <= k; ++dz) {
                const int nz = cz + dz;
                const int bitpos = colbase + dz - shpos;
                if (nz < 0 || nz >= g.dims[2] || bitpos < 0) continue;
                if (((win >> bitpos) & 1u) == 0) continue;
                ++total;
                const float ox = (float)dx * g.res[0];
                const float oy = (float)dy * g.res[1];
                const float oz = (float)dz * g.res[2];
                m[0] += ox; m[1] += oy; m[2] += oz;
                m[3] += ox * ox; m[4] += ox * oy; m[5] += ox * oz;
                m[6] += oy * oy; m[7] += oy * oz; m[8] += oz * oz;
            }
        }
    }
    const float tot = fmaxf((float)total, 1.0f);
    const float mx = m[0] / tot, my = m[1] / tot, mz = m[2] / tot;
    float v[3];
    smallest_eigvec_sym(m[3] / tot - mx * mx, m[4] / tot - mx * my,
                        m[5] / tot - mx * mz, m[6] / tot - my * my,
                        m[7] / tot - my * mz, m[8] / tot - mz * mz, v);
    float c[3];
    center_of_id(g, id, c);
    const float dot = (viewpoint[3L * s] - c[0]) * v[0]
                      + (viewpoint[3L * s + 1] - c[1]) * v[1]
                      + (viewpoint[3L * s + 2] - c[2]) * v[2];
    if (dot < 0.0f)
        for (int a = 0; a < 3; ++a) v[a] = -v[a];
    const bool ok = total >= min_nb;
    for (int a = 0; a < 3; ++a) nvec[(long)a * U + u] = v[a];
    gated[u] = ok;
    if (ok) {
        for (int a = 0; a < 3; ++a) normal[3L * s + a] = v[a];
        normal_found[s] = 1;
    }
}

extern "C" int launch_normal_fit(const void* cand, int U, const void* key,
                                 const void* occ_bits, int W,
                                 const void* viewpoint, const float* geo_f,
                                 const int* geo_i, int k, int min_nb,
                                 void* nvec, void* gated, void* normal,
                                 void* normal_found, void* stream) {
    if (U == 0) return 0;
    const int threads = 128;
    normal_fit_kernel<<<grid_blocks(U, threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const int*)cand, U, (const int*)key, (const int*)occ_bits, W,
        (const float*)viewpoint, make_geo(geo_f, geo_i), k, min_nb,
        (float*)nvec, (unsigned char*)gated, (float*)normal,
        (unsigned char*)normal_found);
    return (int)cudaGetLastError();
}
