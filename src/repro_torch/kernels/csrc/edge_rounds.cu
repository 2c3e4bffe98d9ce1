// Fused fixed-point message-passing rounds of the sparse flow engine.
//
// Replaces the JAX package's Pallas TPU kernels
//   src/repro/kernels/edge_rounds.py : edge_rounds          (padded [V, Dmax] tiles)
//   src/repro/kernels/edge_rounds.py : edge_rounds_bucketed (degree-bucketed tiles)
//
// Both iterate, per task row s,
//     x <- combine(b, reduce_e w[s, i, e] * (x[s, nbr[i, e]] + shift))
// with combine/reduce = (+, +) for "sum" and (max, max) for "max", until
// no entry of x changes or max_rounds rounds ran, and return the number
// of rounds.  Masked slots contribute w = 0.  The row reduce follows
// kernels/ref.py:fold_reduce exactly (pow2 zero-pad, abs, halving), so
// the padded and the bucketed kernel agree bit for bit, and both agree
// bit for bit with the plain PyTorch version.  Every multiply and add is
// an explicitly rounded __fmul_rn/__fadd_rn, so nothing is contracted
// into an FMA.
//
// Design: one CTA per task row.  The row's state x and the next state
// live in shared memory (2·V floats: 80 KB at V = 10^4), so the whole
// early-exit loop runs in one launch and each round reads only the
// weights, neighbour indices and masks from global memory / L2.  A row
// stops as soon as ITS state stops changing (__syncthreads_or): rounds
// past a row's exact fixed point reproduce it, so this equals the
// reference's shared exit; the launch's round count is the max over
// rows (taken by the wrapper).
//
// Slot lanes: a node's padded width P (next pow2 of the tile width) is
// split over a group of min(P, 32) lanes, lane l holding the slots
// ≡ l (mod 32).  Lane-local fold first (the halvings with stride >= 32),
// then __shfl_down_sync with offsets P/2 .. 1 inside the group.
//
// Bound: reading each input once, the roofline bound is set by the
// operations (3 flops a lane a round, times the rounds the data needs)
// or, for short fixed points, by the bytes of w, nbr and mask.  This
// design instead re-reads w, nbr and mask from L2 every round, and a
// round is a latency-bound sequence of passes of the CTA's 8 warps over
// the V rows; only S CTAs run, so S of the 132 SMs work (16 on
// ba_10000).  It is simple and exact, not fast: keeping the tiles in
// shared memory or registers across rounds and spreading a task row over
// several CTAs are the next steps.  A V beyond the shared-memory limit
// is refused rather than served by a second path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float v) {
    p[i] = __float2bfloat16_rn(v);
}

// NaN-propagating max, as torch.maximum / jnp.maximum
__device__ __forceinline__ float maxp(float a, float b) {
    return (a > b || a != a) ? a : b;
}

template <bool kMax>
__device__ __forceinline__ float op(float a, float b) {
    return kMax ? maxp(a, b) : __fadd_rn(a, b);
}

// Lane-local part of the fold: a[0..C) hold slots l, l+32, ..., fold by
// halves (stride 32·C/2 first), leaving the lane's residue in a[0].
template <bool kMax, int C>
__device__ __forceinline__ float lane_fold(float (&a)[C]) {
#pragma unroll
    for (int h = C / 2; h >= 1; h /= 2) {
#pragma unroll
        for (int c = 0; c < h; ++c) a[c] = op<kMax>(a[c], a[c + h]);
    }
    return a[0];
}

// Message of one lane: |w · (x[j] + shift)|, w zeroed on masked slots.
__device__ __forceinline__ float message(float w, bool live, float xj,
                                         float shift) {
    float wm = live ? w : 0.0f;
    return fabsf(__fmul_rn(wm, __fadd_rn(xj, shift)));
}

// One round over a [rows, width] tile for one task.
//   row r's lanes sit at lane_base + r*width (+ e);  wt(lane) gives the
//   lane's weight, nbr/mask the lane's gather index and liveness;
//   node(r) is where the row's result lands.
template <bool kMax, int C, class WFn, class NodeFn>
__device__ bool tile_round(int rows, int width, long lane_base,
                           const int* __restrict__ nbr,
                           const uint8_t* __restrict__ mask, WFn wt,
                           NodeFn node, const float* __restrict__ b_row,
                           const float* __restrict__ x,
                           float* __restrict__ xn, float shift) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    bool changed = false;
    int P = 1;
    while (P < width) P <<= 1;
    if (P >= 32) {                      // one warp per row, C slots a lane
        for (int r = warp; r < rows; r += kWarps) {
            float a[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                int e = lane + 32 * c;
                a[c] = 0.0f;
                if (e < width) {
                    long q = lane_base + (long)r * width + e;
                    a[c] = message(wt(q), mask[q] != 0, x[nbr[q]], shift);
                }
            }
            float v = lane_fold<kMax, C>(a);
#pragma unroll
            for (int off = 16; off >= 1; off >>= 1)
                v = op<kMax>(v, __shfl_down_sync(kFull, v, off));
            if (lane == 0) {
                int i = node(r);
                float y = op<kMax>(b_row[i], v);
                changed |= (y != x[i]);
                xn[i] = y;
            }
        }
    } else {                            // 32/P rows a warp, one slot a lane
        const int per_warp = 32 / P;
        const int sub = lane / P, e = lane % P;
        for (int r0 = warp * per_warp; r0 < rows; r0 += kWarps * per_warp) {
            int r = r0 + sub;
            float v = 0.0f;
            if (r < rows && e < width) {
                long q = lane_base + (long)r * width + e;
                v = message(wt(q), mask[q] != 0, x[nbr[q]], shift);
            }
            for (int off = P / 2; off >= 1; off >>= 1)
                v = op<kMax>(v, __shfl_down_sync(kFull, v, off, P));
            if (e == 0 && r < rows) {
                int i = node(r);
                float y = op<kMax>(b_row[i], v);
                changed |= (y != x[i]);
                xn[i] = y;
            }
        }
    }
    return changed;
}

// ------------------------------------------------------------ padded (K1)
template <bool kMax, int C, class TW, class TB, class TO>
__global__ void __launch_bounds__(kThreads)
edge_rounds_kernel(const TW* __restrict__ w, const TB* __restrict__ b,
                   const int* __restrict__ nbr,
                   const uint8_t* __restrict__ mask, TO* __restrict__ out,
                   int* __restrict__ rounds, int V, int D, float shift,
                   int max_rounds, float* __restrict__ b32) {
    extern __shared__ float smem[];
    const int s = blockIdx.x;
    float* x = smem;
    float* xn = smem + V;
    float* b_row = b32 + (long)s * V;
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
        float bi = load_f(b, (long)s * V + i);
        b_row[i] = bi;
        x[i] = bi;
    }
    __syncthreads();
    const TW* w_row = w + (long)s * V * D;
    auto wt = [w_row](long q) { return load_f(w_row, q); };
    auto node = [](int r) { return r; };
    int k = 1;
    bool changed = tile_round<kMax, C>(V, D, 0, nbr, mask, wt, node, b_row,
                                       x, xn, shift);
    int any = __syncthreads_or(changed);
    while (k < max_rounds && any) {
        float* t = x; x = xn; xn = t;
        changed = tile_round<kMax, C>(V, D, 0, nbr, mask, wt, node, b_row,
                                      x, xn, shift);
        ++k;
        any = __syncthreads_or(changed);
    }
    for (int i = threadIdx.x; i < V; i += blockDim.x)
        store_f(out, (long)s * V + i, xn[i]);
    if (threadIdx.x == 0) rounds[s] = k;
}

// ---------------------------------------------------------- bucketed (K2)
// Buckets in CSR form: bucket k owns rows [row_off[k], row_off[k+1]) of
// `nodes` and lanes [lane_off[k], lane_off[k+1]) of nbr/wsrc/wslot/mask,
// as a [rows_k, width[k]] tile.
template <bool kMax, int C, class TW, class TB, class TO>
__global__ void __launch_bounds__(kThreads)
edge_rounds_bucketed_kernel(
        const TW* __restrict__ w, const TB* __restrict__ b,
        const int* __restrict__ nodes, const int* __restrict__ nbr,
        const int* __restrict__ wsrc, const int* __restrict__ wslot,
        const uint8_t* __restrict__ mask, const int* __restrict__ row_off,
        const long* __restrict__ lane_off, const int* __restrict__ width,
        int n_buckets, long lanes, TO* __restrict__ out,
        int* __restrict__ rounds, int V, int D, float shift, int max_rounds,
        float* __restrict__ b32, float* __restrict__ wtile) {
    extern __shared__ float smem[];
    const int s = blockIdx.x;
    float* x = smem;
    float* xn = smem + V;
    float* b_row = b32 + (long)s * V;
    float* wt_row = wtile + (long)s * lanes;
    const TW* w_row = w + (long)s * V * D;
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
        float bi = load_f(b, (long)s * V + i);
        b_row[i] = bi;
        x[i] = bi;
    }
    // the weight tile w[s, wsrc, wslot], gathered once for all rounds
    for (long q = threadIdx.x; q < lanes; q += blockDim.x)
        wt_row[q] = load_f(w_row, (long)wsrc[q] * D + wslot[q]);
    __syncthreads();
    auto wt = [wt_row](long q) { return wt_row[q]; };

    auto one_round = [&]() {
        bool ch = false;
        for (int kb = 0; kb < n_buckets; ++kb) {
            const int r0 = row_off[kb];
            const int* nodes_b = nodes + r0;
            auto node = [nodes_b](int r) { return nodes_b[r]; };
            ch |= tile_round<kMax, C>(row_off[kb + 1] - r0, width[kb],
                                      lane_off[kb], nbr, mask, wt, node,
                                      b_row, x, xn, shift);
        }
        return ch;
    };
    int k = 1;
    int any = __syncthreads_or(one_round());
    while (k < max_rounds && any) {
        float* t = x; x = xn; xn = t;
        bool ch = one_round();
        ++k;
        any = __syncthreads_or(ch);
    }
    for (int i = threadIdx.x; i < V; i += blockDim.x)
        store_f(out, (long)s * V + i, xn[i]);
    if (threadIdx.x == 0) rounds[s] = k;
}

// dtype codes: 0 = float32, 1 = bfloat16 (w and b share one; the wrapper
// widens a bf16 operand paired with an f32 one, which is exact)
template <bool kMax, int C, class TW, class TB, class TO>
cudaError_t launch_typed(bool bucketed, const void* w, const void* b,
                         const int* nodes, const int* nbr, const int* wsrc,
                         const int* wslot, const uint8_t* mask,
                         const int* row_off, const long* lane_off,
                         const int* width, int n_buckets, long lanes,
                         void* out, int* rounds, int S, int V, int D,
                         float shift, int max_rounds, float* b32,
                         float* wtile, cudaStream_t stream) {
    size_t smem = 2 * sizeof(float) * (size_t)V;
    if (bucketed) {
        auto kern = edge_rounds_bucketed_kernel<kMax, C, TW, TB, TO>;
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        kern<<<S, kThreads, smem, stream>>>(
            (const TW*)w, (const TB*)b, nodes, nbr, wsrc, wslot, mask,
            row_off, lane_off, width, n_buckets, lanes, (TO*)out, rounds, V,
            D, shift, max_rounds, b32, wtile);
    } else {
        auto kern = edge_rounds_kernel<kMax, C, TW, TB, TO>;
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        kern<<<S, kThreads, smem, stream>>>(
            (const TW*)w, (const TB*)b, nbr, mask, (TO*)out, rounds, V, D,
            shift, max_rounds, b32);
    }
    return cudaGetLastError();
}

template <bool kMax, int C>
cudaError_t launch_dtypes(int w_dt, int b_dt, bool bucketed, const void* w,
                          const void* b, const int* nodes, const int* nbr,
                          const int* wsrc, const int* wslot,
                          const uint8_t* mask, const int* row_off,
                          const long* lane_off, const int* width,
                          int n_buckets, long lanes, void* out, int* rounds,
                          int S, int V, int D, float shift, int max_rounds,
                          float* b32, float* wtile, cudaStream_t stream) {
#define ER_ARGS bucketed, w, b, nodes, nbr, wsrc, wslot, mask, row_off, \
    lane_off, width, n_buckets, lanes, out, rounds, S, V, D, shift,     \
    max_rounds, b32, wtile, stream
    if (w_dt == 0 && b_dt == 0)
        return launch_typed<kMax, C, float, float, float>(ER_ARGS);
    if (w_dt == 1 && b_dt == 1)
        return launch_typed<kMax, C, __nv_bfloat16, __nv_bfloat16,
                            __nv_bfloat16>(ER_ARGS);
#undef ER_ARGS
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch of the padded (bucketed = 0) or bucketed (bucketed = 1)
// fixed point.  `cw` is the lanes-per-row count of the widest tile
// rounded up to a power of two divided by 32 (1 when narrower); the
// wrapper computes it.  b32 is [S, V] f32 scratch, wtile [S, lanes] f32
// scratch (bucketed only).  Returns cudaGetLastError() of the launch.
int edge_rounds_launch(int reduce_max, int cw, int w_dt, int b_dt,
                       int bucketed, const void* w, const void* b,
                       const void* nodes, const void* nbr, const void* wsrc,
                       const void* wslot, const void* mask,
                       const void* row_off, const void* lane_off,
                       const void* width, int n_buckets, long lanes,
                       void* out, void* rounds, int S, int V, int D,
                       float shift, int max_rounds, void* b32, void* wtile,
                       void* stream) {
#define ER_CALL(M, C)                                                     \
    return (int)launch_dtypes<M, C>(                                      \
        w_dt, b_dt, bucketed != 0, w, b, (const int*)nodes,               \
        (const int*)nbr, (const int*)wsrc, (const int*)wslot,             \
        (const uint8_t*)mask, (const int*)row_off, (const long*)lane_off, \
        (const int*)width, n_buckets, lanes, out, (int*)rounds, S, V, D,  \
        shift, max_rounds, (float*)b32, (float*)wtile,                    \
        (cudaStream_t)stream)
#define ER_WIDTHS(M)                       \
    switch (cw) {                          \
        case 1: ER_CALL(M, 1);             \
        case 2: ER_CALL(M, 2);             \
        case 4: ER_CALL(M, 4);             \
        case 8: ER_CALL(M, 8);             \
        case 16: ER_CALL(M, 16);           \
        case 32: ER_CALL(M, 32);           \
        default: return (int)cudaErrorInvalidValue; \
    }
    if (reduce_max) {
        ER_WIDTHS(true)
    } else {
        ER_WIDTHS(false)
    }
    return (int)cudaErrorInvalidValue;
#undef ER_WIDTHS
#undef ER_CALL
}

}  // extern "C"
