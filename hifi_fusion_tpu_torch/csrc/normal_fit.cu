// Kernel K4: the refine pass's normal fit.
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
// Bound on the card: latency of scattered loads.  A candidate reads its
// slot, then its key and viewpoint, then 2 bitmap words per column (50
// for k=2) from a 24.5 MB bitmap at the bench size; ~1.3 k flops of
// moments and ~150 of eigen math.  The bench refine's ~12 k candidates
// make under one wave of the card, so the time is the chain of dependent
// memory round trips each candidate waits for, and its serial sums, not
// bytes or flops.
//
// Design: one thread a candidate, three dependent round trips (slot;
// key and viewpoint; every column's two words at once) instead of one a
// column.  Each column's words are cut to its (2k+1)-bit z window,
// masked to the cells inside the grid, and the thread sums the 9 moments
// over the occupied bits in (dx, dy, dz) order.  The plain version
// (ops/refine.py normal_fit_plain) sums in the same order with the same
// f32 operations (the library is built with -fmad=false), so the gate
// count is exact and the sums bit-identical; that matters because a
// window whose two smallest eigenvalues nearly coincide has an
// ill-conditioned normal, where any change of rounding turns the normal
// by up to ~1e-3.  The window of k = 1, 2, 3 is one round of loads
// (template); any other k up to 15 (a column's 2k+1 bits in two words)
// takes rounds of 32 columns.  A group of 8 or 32 lanes a candidate, its
// windows gathered by shuffles, was slower on the card (PERF.md):
// the card has the threads to spare, but each lane of a group repeats the
// sums.  Gated candidates write normal and normal_found in place; every
// candidate also writes its oriented normal and gate to nvec / gated,
// which the line-cell stage reads.

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
    // the chosen cross product by value (a pointer select would put the
    // three in local memory)
    float c[3];
    for (int a = 0; a < 3; ++a)
        c[a] = best12 ? c12[a] : (best02 ? c02[a] : c01[a]);
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

constexpr int kThreads = 128;
constexpr int kMaxK = 15;

template <int KT>
__global__ void __launch_bounds__(kThreads) normal_fit_kernel(
    const int* __restrict__ cand, int U, const int* __restrict__ key,
    const uint32_t* __restrict__ occ_bits, int W,
    const float* __restrict__ viewpoint, Geo g, int k_arg, int min_nb,
    float* __restrict__ nvec, unsigned char* __restrict__ gated,
    float* __restrict__ normal, unsigned char* __restrict__ normal_found) {
    // columns a round of loads: the whole window for k = KT
    constexpr int CH = KT > 0 ? (2 * KT + 1) * (2 * KT + 1) : 32;
    const int k = KT > 0 ? KT : k_arg;
    const int S = 2 * k + 1, NC = S * S;
    const int u = blockIdx.x * kThreads + threadIdx.x;
    if (u >= U) return;
    const int s = cand[u];
    const int id = key[s];
    const float vp0 = viewpoint[3L * s], vp1 = viewpoint[3L * s + 1],
                vp2 = viewpoint[3L * s + 2];
    const int cz = id % g.dims[2];
    const int cy = (id / g.dims[2]) % g.dims[1];
    const int cx = (id / g.dims[2]) / g.dims[1];
    const uint32_t zmask = z_window_mask(g, cz, k);

    int total = 0;
    float m[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int c0 = 0; c0 < NC; c0 += CH) {
        // every word load of the round first
        uint32_t w0[CH], w1[CH];
#pragma unroll
        for (int q = 0; q < CH; ++q) {
            const int col = column_base(g, cx, cy, cz, c0 + q, S, k, NC);
            w0[q] = 0u;
            w1[q] = 0u;
            if (col >= 0) {
                const int w0i = min(max(col - k, 0) >> 5, W - 1);
                w0[q] = __ldg(occ_bits + w0i);
                if (w0i + 1 < W) w1[q] = __ldg(occ_bits + w0i + 1);
            }
        }
        // then the columns in order, each over its occupied z bits
#pragma unroll
        for (int q = 0; q < CH; ++q) {
            const int c = c0 + q;
            const int col = column_base(g, cx, cy, cz, c, S, k, NC);
            if (col < 0) continue;
            uint32_t b = column_window(w0[q], w1[q], col, k, zmask);
            const float ox = (float)(c / S - k) * g.res[0];
            const float oy = (float)(c % S - k) * g.res[1];
            const float oxx = ox * ox, oxy = ox * oy, oyy = oy * oy;
            total += __popc(b);
            while (b) {
                const int t = __ffs(b) - 1;
                b &= b - 1u;
                const float oz = (float)(t - k) * g.res[2];
                m[0] += ox; m[1] += oy; m[2] += oz;
                m[3] += oxx; m[4] += oxy; m[5] += ox * oz;
                m[6] += oyy; m[7] += oy * oz; m[8] += oz * oz;
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
    const float dot = (vp0 - c[0]) * v[0] + (vp1 - c[1]) * v[1]
                      + (vp2 - c[2]) * v[2];
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

template <int KT>
static void launch(const void* cand, int U, const void* key,
                   const void* occ_bits, int W, const void* viewpoint,
                   const Geo& g, int k, int min_nb, void* nvec, void* gated,
                   void* normal, void* normal_found, cudaStream_t stream) {
    normal_fit_kernel<KT><<<grid_blocks(U, kThreads), kThreads, 0, stream>>>(
            (const int*)cand, U, (const int*)key, (const uint32_t*)occ_bits,
            W, (const float*)viewpoint, g, k, min_nb, (float*)nvec,
            (unsigned char*)gated, (float*)normal,
            (unsigned char*)normal_found);
}

extern "C" int launch_normal_fit(const void* cand, int U, const void* key,
                                 const void* occ_bits, int W,
                                 const void* viewpoint, const float* geo_f,
                                 const int* geo_i, int k, int min_nb,
                                 void* nvec, void* gated, void* normal,
                                 void* normal_found, void* stream) {
    if (k < 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
    if (U == 0) return 0;
    const Geo g = make_geo(geo_f, geo_i);
    const cudaStream_t st = (cudaStream_t)stream;
    switch (k) {
        case 1: launch<1>(cand, U, key, occ_bits, W, viewpoint, g, k,
                          min_nb, nvec, gated, normal, normal_found, st);
                break;
        case 2: launch<2>(cand, U, key, occ_bits, W, viewpoint, g, k,
                          min_nb, nvec, gated, normal, normal_found, st);
                break;
        case 3: launch<3>(cand, U, key, occ_bits, W, viewpoint, g, k,
                          min_nb, nvec, gated, normal, normal_found, st);
                break;
        default: launch<0>(cand, U, key, occ_bits, W, viewpoint, g, k,
                           min_nb, nvec, gated, normal, normal_found, st);
    }
    return (int)cudaGetLastError();
}
