// Batched Eq. 15 QP rows: the scaled projection onto the simplex with
// blocked coordinates pinned to zero.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/simplex_project.py : simplex_project
// but follows its oracle (core/sgp.py:project_rows, ported as
// kernels/ref.py:simplex_project_ref) rather than the Pallas body:
//   w = 1/(2M), q = φ - d/(2M) on permitted coordinates ((q, w) = (-BIG, 0)
//   on blocked ones, d = BIG there), bisection on the dual λ of
//   Σ_j max(q_j - λ w_j, 0) = 1 from the bracket [min lo_j, max hi_j],
//   stopping when the bracket no longer moves or after n_iter halvings,
//   snap below SNAP_TOL, renormalise, fall back to the one-hot at the
//   FIRST argmin of d, and emit an all-zero row where every coordinate
//   is blocked.  A row that stops early equals the oracle's shared exit:
//   a frozen bracket stays frozen.
//
// Design: one warp per row; lane l keeps coordinates l, l+32, ... in
// registers (KPL of them), so every halving is KPL multiply-subtracts
// and one warp butterfly sum, with no memory traffic after the first
// load.  All lanes end a butterfly with the same bits, so the bracket
// decisions are warp-uniform.
//
// Bound: memory, for the single pass over φ, δ, M, permitted and the
// output (17 bytes a coordinate); the bisection (about 30 halvings of
// 3 flops a coordinate) stays in registers.  Each halving ends in a
// warp butterfly, so narrow rows (K ~ 15) leave most lanes idle and the
// kernel is latency-bound there; wide rows (K ~ 278) come closer to the
// byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e12f;
constexpr float kSnap = 1e-12f;

__device__ __forceinline__ float maxp(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
    return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

template <int KPL>
__global__ void __launch_bounds__(kThreads)
simplex_project_kernel(const float* __restrict__ phi,
                       const float* __restrict__ delta,
                       const float* __restrict__ M,
                       const uint8_t* __restrict__ perm,
                       float* __restrict__ out, int R, int K, int n_iter) {
    const int lane = threadIdx.x & 31;
    const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= R) return;               // warp-uniform
    const long base = row * K;
    float q[KPL], w[KPL], d[KPL];
    float lo = kBig, hi = -kBig;
    bool any_perm = false;
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
        const int j = lane + 32 * c;
        q[c] = -kBig; w[c] = 0.0f;
        d[c] = __int_as_float(0x7f800000);   // past the row: never the argmin
        if (j < K) {
            d[c] = kBig;
            const bool p = perm[base + j] != 0;
            if (p) {
                any_perm = true;
                const float Ms = maxp(M[base + j], 1e-12f);
                const float phi0 = phi[base + j];
                const float dj = delta[base + j];
                const float twoM = __fmul_rn(2.0f, Ms);
                lo = minp(lo, __fsub_rn(-dj, __fmul_rn(twoM,
                                         __fsub_rn(1.0f, phi0))));
                hi = maxp(hi, __fadd_rn(-dj, __fmul_rn(twoM, phi0)));
                w[c] = __fdiv_rn(1.0f, twoM);
                q[c] = __fsub_rn(phi0, __fdiv_rn(dj, twoM));
                d[c] = dj;
            }
        }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
        lo = minp(lo, __shfl_xor_sync(kFull, lo, off));
        hi = maxp(hi, __shfl_xor_sync(kFull, hi, off));
    }
    any_perm = __any_sync(kFull, any_perm);

    for (int it = 0; it < n_iter; ++it) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < KPL; ++c)
            s = __fadd_rn(s, fmaxf(__fsub_rn(q[c], __fmul_rn(mid, w[c])),
                                   0.0f));
        const bool up = warp_sum(s) > 1.0f;
        const float lo2 = up ? mid : lo, hi2 = up ? hi : mid;
        const bool changed = (lo2 != lo) || (hi2 != hi);
        lo = lo2;
        hi = hi2;
        if (!changed) break;
    }
    const float lam = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    float v[KPL];
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
        const float vc = fmaxf(__fsub_rn(q[c], __fmul_rn(lam, w[c])), 0.0f);
        v[c] = vc > kSnap ? vc : 0.0f;
        s = __fadd_rn(s, v[c]);
    }
    s = warp_sum(s);
    // first argmin of d over the row
    float dmin = d[0];
    int jmin = lane;
#pragma unroll
    for (int c = 1; c < KPL; ++c) {
        if (d[c] < dmin) { dmin = d[c]; jmin = lane + 32 * c; }
    }
    if (jmin >= K) { dmin = __int_as_float(0x7f800000); jmin = 1 << 30; }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, dmin, off);
        const int oj = __shfl_xor_sync(kFull, jmin, off);
        if (od < dmin || (od == dmin && oj < jmin)) { dmin = od; jmin = oj; }
    }
    const float denom = fmaxf(s, 1e-30f);
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
        const int j = lane + 32 * c;
        if (j < K) {
            float o = s > 0.0f ? __fdiv_rn(v[c], denom)
                               : (j == jmin ? 1.0f : 0.0f);
            out[base + j] = any_perm ? o : 0.0f;
        }
    }
}

template <int KPL>
cudaError_t launch(const float* phi, const float* delta, const float* M,
                   const uint8_t* perm, float* out, int R, int K,
                   int n_iter, cudaStream_t stream) {
    const int blocks = (R + kWarps - 1) / kWarps;
    simplex_project_kernel<KPL><<<blocks, kThreads, 0, stream>>>(
        phi, delta, M, perm, out, R, K, n_iter);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// All row arrays [R, K] row-major; permitted as one byte a coordinate.
// `kpl` is ceil(K / 32) rounded up to a power of two (the wrapper
// computes it).  Returns cudaGetLastError() of the launch.
int simplex_project_launch(int kpl, const void* phi, const void* delta,
                           const void* M, const void* perm, void* out,
                           int R, int K, int n_iter, void* stream) {
    if (R == 0) return 0;
#define SP_CALL(N)                                                        \
    return (int)launch<N>((const float*)phi, (const float*)delta,         \
                          (const float*)M, (const uint8_t*)perm,          \
                          (float*)out, R, K, n_iter, (cudaStream_t)stream)
    switch (kpl) {
        case 1: SP_CALL(1);
        case 2: SP_CALL(2);
        case 4: SP_CALL(4);
        case 8: SP_CALL(8);
        case 16: SP_CALL(16);
        default: return (int)cudaErrorInvalidValue;
    }
#undef SP_CALL
}

}  // extern "C"
