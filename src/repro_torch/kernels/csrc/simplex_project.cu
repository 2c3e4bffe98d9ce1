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
// The rows of the sparse engine are almost empty: a (node, task) row of
// ba_10000 has K = 278 slots and about five permitted ones (its
// out-edges that are not blocked, and the local slot).  Blocked
// coordinates add exact zeros to every sum, so the work is spent on the
// permitted ones only:
//
// * each warp takes a batch of B consecutive rows (B from the wrapper,
//   ~2.3 KB of mask), copies the batch's mask into shared memory with
//   cp.async and writes the batch's output as zeros with 16-byte stores;
// * it scans each row's mask with ballots and compacts the permitted
//   columns, in column order, into a list (so the first argmin of δ is
//   unchanged); a row with more than 32 is solved at once by the whole
//   warp, lane l holding its coordinates l, l+32, ... (KPL = ⌈K / 32⌉
//   registers; rounded up to a power of two it was 8-10 % slower on
//   ba_10000's QPs, whose hub rows take this route);
// * the other rows are solved in sub-warp groups of G = 4, 8, 16 or 32
//   lanes (G the next power of two >= the row's permitted count, at
//   least 4), 32/G rows at a time, one coordinate a lane: a halving is
//   one multiply-subtract and a log2(G)-level butterfly; each group
//   stores its row's permitted values over the zeros.
//
// Only the summation order differs from the plain version's (compacted
// lanes, then a butterfly), so results agree to float32 rounding.
//
// Bound: memory.  Each coordinate's mask byte is read and its output
// written once (5 bytes), and φ, δ, M are read only where permitted (12
// bytes more each); the bisection (about 30 halvings) stays in
// registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e12f;
constexpr float kSnap = 1e-12f;
constexpr int kMaxRows = 32;          // rows a warp's batch may hold

__device__ __forceinline__ float maxp(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
    return (a < b || a != a) ? a : b;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// One warp's shared memory: the staged mask of its batch (16-byte chunks
// covering the batch's bytes), the narrow rows' column lists [B][32], the
// column list of the row being scanned [K], and per row its permitted
// count, first blocked column and the class order.
struct WarpSmem {
    int stage, cols, wide, meta, bytes;
    __host__ __device__ WarpSmem(int B, int K)
        : stage(0), cols(round16(B * K + 48)), wide(cols + B * 64),
          meta(wide + round16(2 * K)), bytes(meta + 160) {}
};

// Dual setup of one permitted coordinate (the oracle's dual_setup).
struct Coord {
    float q, w, d, lo, hi;
};
__device__ __forceinline__ Coord coord(const float* __restrict__ phi,
                                       const float* __restrict__ delta,
                                       const float* __restrict__ M, long i) {
    const float Ms = maxp(M[i], 1e-12f);
    const float phi0 = phi[i];
    const float dj = delta[i];
    const float twoM = __fmul_rn(2.0f, Ms);
    Coord c;
    c.lo = __fsub_rn(-dj, __fmul_rn(twoM, __fsub_rn(1.0f, phi0)));
    c.hi = __fadd_rn(-dj, __fmul_rn(twoM, phi0));
    c.w = __fdiv_rn(1.0f, twoM);
    c.q = __fsub_rn(phi0, __fdiv_rn(dj, twoM));
    c.d = dj;
    return c;
}
__device__ __forceinline__ Coord blocked_coord() {
    Coord c;
    c.q = -kBig; c.w = 0.0f; c.lo = kBig; c.hi = -kBig;
    c.d = __int_as_float(0x7f800000);   // never the argmin
    return c;
}

// Butterfly reductions over groups of G lanes (mask: the group's lanes).
template <int G>
__device__ __forceinline__ float group_sum(unsigned mask, float v) {
#pragma unroll
    for (int off = G / 2; off >= 1; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(mask, v, off, G));
    return v;
}
template <int G>
__device__ __forceinline__ void group_bracket(unsigned mask, float& lo,
                                              float& hi) {
#pragma unroll
    for (int off = G / 2; off >= 1; off >>= 1) {
        lo = minp(lo, __shfl_xor_sync(mask, lo, off, G));
        hi = maxp(hi, __shfl_xor_sync(mask, hi, off, G));
    }
}
// first argmin (d, column) over the group: the smaller d, then the
// smaller column
template <int G>
__device__ __forceinline__ void group_argmin(unsigned mask, float& dm,
                                             int& jm) {
#pragma unroll
    for (int off = G / 2; off >= 1; off >>= 1) {
        const float od = __shfl_xor_sync(mask, dm, off, G);
        const int oj = __shfl_xor_sync(mask, jm, off, G);
        if (od < dm || (od == dm && oj < jm)) { dm = od; jm = oj; }
    }
}

// v_j(λ) = max(q_j - λ w_j, 0), snapped to 0 below SNAP_TOL
__device__ __forceinline__ float snapped(float q, float w, float lam) {
    const float v = fmaxf(__fsub_rn(q, __fmul_rn(lam, w)), 0.0f);
    return v > kSnap ? v : 0.0f;
}

// The bisection, snap and write-out of one row whose permitted
// coordinates are spread over a group of G lanes, KPL a lane (lane t of
// the group holds compacted coordinates t, t+G, ..., their columns in
// `cols`).  n >= 1 of them; fb is the row's first blocked column (K when
// none): the one-hot fallback goes there when no permitted δ is below
// BIG.  Only q and w stay in registers: the columns are read from the
// list, v is recomputed where it is written, and δ is read again on the
// fallback alone.
template <int G, int KPL>
__device__ __forceinline__ void solve_row(
        unsigned mask, int t, const uint16_t* __restrict__ cols, int n,
        int fb, long base, int K, const float* __restrict__ phi,
        const float* __restrict__ delta, const float* __restrict__ M,
        float* __restrict__ out, int n_iter) {
    float q[KPL], w[KPL];
    float lo = kBig, hi = -kBig;
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
        const int p = t + G * c;
        const Coord x = p < n ? coord(phi, delta, M, base + cols[p])
                              : blocked_coord();
        q[c] = x.q; w[c] = x.w;
        lo = minp(lo, x.lo);
        hi = maxp(hi, x.hi);
    }
    group_bracket<G>(mask, lo, hi);
    for (int it = 0; it < n_iter; ++it) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < KPL; ++c)
            s = __fadd_rn(s, fmaxf(__fsub_rn(q[c], __fmul_rn(mid, w[c])),
                                   0.0f));
        const bool up = group_sum<G>(mask, s) > 1.0f;
        const float lo2 = up ? mid : lo, hi2 = up ? hi : mid;
        const bool changed = (lo2 != lo) || (hi2 != hi);
        lo = lo2;
        hi = hi2;
        if (!changed) break;
    }
    const float lam = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < KPL; ++c) s = __fadd_rn(s, snapped(q[c], w[c], lam));
    s = group_sum<G>(mask, s);
    if (s > 0.0f) {
        const float denom = fmaxf(s, 1e-30f);
#pragma unroll
        for (int c = 0; c < KPL; ++c)
            if (t + G * c < n)
                out[base + cols[t + G * c]] =
                    __fdiv_rn(snapped(q[c], w[c], lam), denom);
        return;
    }
    float dm = __int_as_float(0x7f800000);
    int jm = 1 << 30;
    if (t < n) { dm = delta[base + cols[t]]; jm = cols[t]; }
#pragma unroll
    for (int c = 1; c < KPL; ++c) {
        const int p = t + G * c;
        if (p < n && delta[base + cols[p]] < dm) {
            dm = delta[base + cols[p]];
            jm = cols[p];
        }
    }
    group_argmin<G>(mask, dm, jm);
    if (fb < K && (dm > kBig || (dm == kBig && fb < jm))) jm = fb;
    if (t == 0 && jm < K) out[base + jm] = 1.0f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

template <int KPL>
__global__ void __launch_bounds__(kThreads, 1)
simplex_project_kernel(const float* __restrict__ phi,
                       const float* __restrict__ delta,
                       const float* __restrict__ M,
                       const uint8_t* __restrict__ perm,
                       float* __restrict__ out, int R, int K, int B,
                       int n_iter) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long row0 = ((long)blockIdx.x * kWarps + warp) * B;
    if (row0 >= R) return;                       // warp-uniform
    const int nb = R - row0 < B ? (int)(R - row0) : B;
    const WarpSmem L(B, K);
    unsigned char* ws = smem_raw + (size_t)warp * L.bytes;
    uint8_t* stage = ws + L.stage;
    uint16_t* cols = reinterpret_cast<uint16_t*>(ws + L.cols);   // [B][32]
    uint16_t* wide = reinterpret_cast<uint16_t*>(ws + L.wide);   // [K]
    int16_t* cnt = reinterpret_cast<int16_t*>(ws + L.meta);      // [32]
    int16_t* first_blocked = cnt + kMaxRows;                     // [32]
    uint8_t* order = reinterpret_cast<uint8_t*>(first_blocked + kMaxRows);

    // 1. the batch's mask bytes into shared memory, 16-byte chunks
    const uintptr_t base = (uintptr_t)perm, end = base + (uintptr_t)R * K;
    const uintptr_t a0 = base + (uintptr_t)row0 * K;
    const uintptr_t a1 = a0 + (uintptr_t)nb * K;
    const uintptr_t c0 = a0 >> 4, c1 = (a1 + 15) >> 4;
    for (uintptr_t c = c0 + lane; c < c1; c += 32) {
        const uintptr_t g = c << 4;
        uint8_t* dst = stage + ((c - c0) << 4);
        if (g >= base && g + 16 <= end) {
            cp_async16(dst, (const void*)g);
        } else {                 // a chunk across the tensor's ends
            for (int k = 0; k < 16; ++k)
                if (g + k >= base && g + k < end)
                    dst[k] = *(const uint8_t*)(g + k);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // 2. the batch's output rows as zeros, 16 bytes a store where aligned
    {
        float* o = out + row0 * K;
        const long n_o = (long)nb * K;
        const long mis = (long)((4 - (((uintptr_t)o >> 2) & 3)) & 3);
        const long head = mis < n_o ? mis : n_o;
        const long n4 = (n_o - head) >> 2;
        if (lane < head) o[lane] = 0.0f;
        float4* o4 = reinterpret_cast<float4*>(o + head);
        for (long i = lane; i < n4; i += 32)
            o4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const long tail = head + 4 * n4;
        if (tail + lane < n_o) o[tail + lane] = 0.0f;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();    // staged mask and zeros ordered before what follows

    // 3. scan each row: permitted count, compacted columns, first blocked
    const uint8_t* mrow = stage + (a0 - (c0 << 4));
    const unsigned lt = (1u << lane) - 1u;
    for (int i = 0; i < nb; ++i, mrow += K) {
        int n = 0, fb = K;
        for (int j0 = 0; j0 < K; j0 += 32) {
            const int col = j0 + lane;
            const bool valid = col < K;
            const bool p = valid && mrow[col] != 0;
            const unsigned bal = __ballot_sync(kFull, p);
            const unsigned blk = __ballot_sync(kFull, valid && !p);
            if (fb == K && blk) fb = j0 + __ffs(blk) - 1;
            if (p) {
                const int rank = n + __popc(bal & lt);
                if (rank < 32) cols[i * 32 + rank] = (uint16_t)col;
                if (KPL > 1) wide[rank] = (uint16_t)col;
            }
            n += __popc(bal);
        }
        if (lane == 0) { cnt[i] = (int16_t)n; first_blocked[i] = (int16_t)fb; }
        if (KPL > 1 && n > 32) {        // a wide row: the whole warp at once
            __syncwarp();
            solve_row<32, KPL>(kFull, lane, wide, n, fb, (row0 + i) * K, K,
                               phi, delta, M, out, n_iter);
        }
        __syncwarp();
    }

    // 4. the narrow rows, class by class, 32/G rows at a time
    const int n_me = lane < nb ? cnt[lane] : 0;
    const int cls = (n_me == 0 || n_me > 32) ? -1
                    : n_me <= 4 ? 0 : n_me <= 8 ? 1 : n_me <= 16 ? 2 : 3;
#define SP_CLASS(CLS, G)                                                   \
    {                                                                      \
        const unsigned bal = __ballot_sync(kFull, cls == CLS);             \
        if (bal) {                                                         \
            if (cls == CLS) order[__popc(bal & lt)] = (uint8_t)lane;       \
            __syncwarp();                                                  \
            const int total = __popc(bal), g = lane / G, t = lane % G;     \
            const unsigned gm = (kFull >> (32 - G)) << (g * G);            \
            for (int k = g; k < total; k += 32 / G) {                      \
                const int i = order[k];                                    \
                solve_row<G, 1>(gm, t, cols + i * 32, cnt[i],              \
                                first_blocked[i], (row0 + i) * K, K, phi,  \
                                delta, M, out, n_iter);                    \
            }                                                              \
            __syncwarp();                                                  \
        }                                                                  \
    }
    SP_CLASS(0, 4)
    SP_CLASS(1, 8)
    SP_CLASS(2, 16)
    SP_CLASS(3, 32)
#undef SP_CLASS
}

template <int KPL>
cudaError_t launch(const float* phi, const float* delta, const float* M,
                   const uint8_t* perm, float* out, int R, int K, int B,
                   int n_iter, cudaStream_t stream) {
    const long warps = (R + (long)B - 1) / B;
    const int blocks = (int)((warps + kWarps - 1) / kWarps);
    const size_t smem = (size_t)kWarps * WarpSmem(B, K).bytes;
    auto kern = simplex_project_kernel<KPL>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<blocks, kThreads, smem, stream>>>(phi, delta, M, perm, out, R, K,
                                             B, n_iter);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// All row arrays [R, K] row-major; permitted as one byte a coordinate.
// `rows_per_warp` (1..32) is B, the rows of a warp's batch.  The
// full-warp route holds ⌈K / 32⌉ (1..16) registers a lane.  Returns
// cudaGetLastError() of the launch.
int simplex_project_launch(int rows_per_warp, const void* phi,
                           const void* delta, const void* M,
                           const void* perm, void* out, int R, int K,
                           int n_iter, void* stream) {
    if (R == 0) return 0;
    if (rows_per_warp < 1 || rows_per_warp > kMaxRows || K < 1)
        return (int)cudaErrorInvalidValue;
    const int kpl = (K + 31) / 32;
#define SP_CALL(N)                                                        \
    case N:                                                               \
        return (int)launch<N>((const float*)phi, (const float*)delta,     \
                              (const float*)M, (const uint8_t*)perm,      \
                              (float*)out, R, K, rows_per_warp, n_iter,   \
                              (cudaStream_t)stream)
    switch (kpl) {
        SP_CALL(1); SP_CALL(2); SP_CALL(3); SP_CALL(4); SP_CALL(5);
        SP_CALL(6); SP_CALL(7); SP_CALL(8); SP_CALL(9); SP_CALL(10);
        SP_CALL(11); SP_CALL(12); SP_CALL(13); SP_CALL(14); SP_CALL(15);
        SP_CALL(16);
        default: return (int)cudaErrorInvalidValue;
    }
#undef SP_CALL
}

}  // extern "C"
