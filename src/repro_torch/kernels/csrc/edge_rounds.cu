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
// K1 (padded): one CTA per task row.  The row's state x and the next
// state live in shared memory (2·V floats: 8 KB at V = 1000), so the
// whole early-exit loop runs in one launch and each round reads only the
// weights, neighbour indices and masks from global memory / L2.  A row
// stops as soon as ITS state stops changing (__syncthreads_or): rounds
// past a row's exact fixed point reproduce it, so this equals the
// reference's shared exit; the launch's round count is the max over
// rows (taken by the wrapper).
//
// K2 (bucketed): one thread-block cluster of c CTAs per task row (c from
// the shapes: 8 at ba_10000's S = 16, 4 for its stacked taint pair).
// The row's bucket rows are cut into c ranges balanced by lanes; each
// CTA keeps its rows' state and its lanes' weights, neighbours and masks
// in shared memory for every round, and reads its neighbours' state from
// the owners' shared memory (distributed shared memory); a cluster
// barrier separates the rounds and the CTAs' change flags are OR-reduced
// across the cluster.  So 128 SMs work at S = 16 instead of 16, and a
// CTA holds a c-th of the state and tiles.
//
// Slot lanes: a node's padded width P (next pow2 of the tile width) is
// split over a group of min(P, 32) lanes, lane l holding the slots
// ≡ l (mod 32).  Lane-local fold first (the halvings with stride >= 32),
// then __shfl_down_sync with offsets P/2 .. 1 inside the group; K1 and K2
// fold every node in this order, within one lane group.
//
// Bound: reading each input once, the roofline bound is set by the
// operations (3 flops a lane a round, times the rounds the data needs)
// or, for short fixed points, by the bytes of w, nbr and mask.  Both
// kernels are bound instead by a round's latency: K1's 8 warps pass over
// the V rows with dependent L2 loads; K2's CTAs pass over a c-th of the
// rows with shared and distributed shared loads, then meet at the
// cluster barrier.  A V beyond what one CTA (K1) or the largest cluster
// (K2) holds is refused rather than served by a second path.

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
// One thread-block cluster of c CTAs per task row: row s is cluster s,
// rank r its r-th CTA.  The row's bucket rows, laid end to end, are cut
// into c contiguous ranges balanced by lanes (kernels/edge_rounds.py:
// cluster_plan, which also packs every lane's neighbour as owner rank |
// owner-local row << 4).  Rank r owns the nodes of rows [row_start[r],
// row_start[r+1]) and keeps, in its shared memory, their x, next x and
// inject in row order, and its lanes' weights w[s, wsrc, wslot], packed
// neighbours and masks, gathered once a launch and kept for every
// round.  A round: each CTA folds its rows from the current x of any
// rank (its own, or a peer's by ld.shared::cluster through mapa), writes
// their next x into its own buffer, stores its change flag into every rank's flag slots, and
// the cluster barrier (release / acquire) separates the Jacobi rounds.
// 16 warps a CTA; 8 where a lane holds 32 slots (tiles wider than 512),
// so that the fold's registers fit without spilling
__host__ __device__ constexpr int k2_threads(int C) {
    return C >= 32 ? 256 : 512;
}
constexpr int kMaxCluster = 16;
constexpr int kMaxSegs = 32;      // buckets a launch may have

size_t k2_smem_bytes(int rows_cap, int lanes_cap) {
    return sizeof(float) * (3 * (size_t)rows_cap + 2 * (size_t)lanes_cap
                            + 2 * kMaxCluster)
        + sizeof(int4) * kMaxSegs + 16 + (size_t)lanes_cap;
}

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}
__device__ __forceinline__ unsigned cluster_ctas() {
    unsigned n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
    return n;
}
// every thread of every CTA of the cluster; orders shared memory writes
// (local and remote) before it against reads after it
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
// the float at shared address `addr` of cluster rank `rank`
__device__ __forceinline__ float ld_cluster(unsigned addr, unsigned rank) {
    unsigned remote;
    float v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(addr), "r"(rank));
    asm volatile("ld.shared::cluster.f32 %0, [%1];"
                 : "=f"(v) : "r"(remote));
    return v;
}
__device__ __forceinline__ void st_cluster(unsigned addr, unsigned rank,
                                           int v) {
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(addr), "r"(rank));
    asm volatile("st.shared::cluster.s32 [%0], %1;"
                 :: "r"(remote), "r"(v) : "memory");
}
// x of the node behind a packed neighbour: from this CTA's own x when it
// owns the node, else from the owner's (`xa`: the shared address of this
// round's x buffer, laid out alike on every rank)
__device__ __forceinline__ float gather(const float* x, unsigned xa,
                                        int loc, unsigned rank) {
    const unsigned r = (unsigned)loc & 15u, off = (unsigned)(loc >> 4);
    return r == rank ? x[off] : ld_cluster(xa + 4u * off, r);
}

// One round over one bucket's rows on this rank (`rows` rows of `width`
// lanes from rank-local lane `lane0` and row `row0`): the fold of
// tile_round (lane_fold, then the shuffles), on the tiles in shared
// memory.
template <bool kMax, int C>
__device__ bool cluster_tile_round(int rows, int width, int lane0, int row0,
                                   const float* __restrict__ wt,
                                   const int* __restrict__ loc,
                                   const uint8_t* __restrict__ mk,
                                   const float* __restrict__ bl,
                                   const float* __restrict__ x, unsigned xa,
                                   unsigned rank, float* __restrict__ xn,
                                   float shift) {
    constexpr int kWarps2 = k2_threads(C) / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    bool changed = false;
    int P = 1;
    while (P < width) P <<= 1;
    if (P >= 32) {                      // one warp per row, C slots a lane
        for (int r = warp; r < rows; r += kWarps2) {
            float a[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int e = lane + 32 * c;
                a[c] = 0.0f;
                if (e < width) {
                    const int q = lane0 + r * width + e;
                    a[c] = message(wt[q], mk[q] != 0,
                                   gather(x, xa, loc[q], rank), shift);
                }
            }
            float v = lane_fold<kMax, C>(a);
#pragma unroll
            for (int off = 16; off >= 1; off >>= 1)
                v = op<kMax>(v, __shfl_down_sync(kFull, v, off));
            if (lane == 0) {
                const int i = row0 + r;
                const float y = op<kMax>(bl[i], v);
                changed |= (y != x[i]);
                xn[i] = y;
            }
        }
    } else {                            // 32/P rows a warp, one slot a lane
        const int per_warp = 32 / P;
        const int sub = lane / P, e = lane % P;
        for (int r0 = warp * per_warp; r0 < rows;
             r0 += kWarps2 * per_warp) {
            const int r = r0 + sub;
            float v = 0.0f;
            if (r < rows && e < width) {
                const int q = lane0 + r * width + e;
                v = message(wt[q], mk[q] != 0, gather(x, xa, loc[q], rank),
                            shift);
            }
            for (int off = P / 2; off >= 1; off >>= 1)
                v = op<kMax>(v, __shfl_down_sync(kFull, v, off, P));
            if (e == 0 && r < rows) {
                const int i = row0 + r;
                const float y = op<kMax>(bl[i], v);
                changed |= (y != x[i]);
                xn[i] = y;
            }
        }
    }
    return changed;
}

// Buckets in CSR form: bucket k owns rows [row_off[k], row_off[k+1]) of
// `nodes` and lanes [lane_off[k], lane_off[k+1]) of loc/wsrc/wslot/mask,
// as a [rows_k, width[k]] tile; rank r owns rows [row_start[r],
// row_start[r+1]) and lanes [lane_start[r], lane_start[r+1]).
template <bool kMax, int C, class TW, class TB, class TO>
__global__ void __launch_bounds__(k2_threads(C), 1)
edge_rounds_bucketed_kernel(
        const TW* __restrict__ w, const TB* __restrict__ b,
        const int* __restrict__ nodes, const int* __restrict__ loc,
        const int* __restrict__ wsrc, const int* __restrict__ wslot,
        const uint8_t* __restrict__ mask, const int* __restrict__ row_off,
        const long* __restrict__ lane_off, const int* __restrict__ width,
        int n_buckets, const int* __restrict__ row_start,
        const long* __restrict__ lane_start, TO* __restrict__ out,
        int* __restrict__ rounds, int V, int D, float shift, int max_rounds,
        int rows_cap, int lanes_cap) {
    constexpr int kThreads2 = k2_threads(C);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const unsigned n_ranks = cluster_ctas(), rank = cluster_rank();
    const int s = blockIdx.x / n_ranks, tid = threadIdx.x;
    const int R0 = row_start[rank], n_rows = row_start[rank + 1] - R0;
    const long L0 = lane_start[rank];
    const int n_lanes = (int)(lane_start[rank + 1] - L0);
    // rows_cap and lanes_cap are multiples of 4: every part 16-byte aligned
    float* x = reinterpret_cast<float*>(smem_raw);   // [rows_cap]
    float* xn = x + rows_cap;                         // [rows_cap]
    float* bl = xn + rows_cap;                        // [rows_cap]
    float* wt = bl + rows_cap;                        // [lanes_cap]
    int* lc = reinterpret_cast<int*>(wt + lanes_cap); // [lanes_cap]
    int* flags = lc + lanes_cap;                      // [2][kMaxCluster]
    // one bucket's rows on this rank: (rows, width, first lane, first row)
    int4* segs = reinterpret_cast<int4*>(flags + 2 * kMaxCluster);
    int* n_segs = reinterpret_cast<int*>(segs + kMaxSegs);
    uint8_t* mk = reinterpret_cast<uint8_t*>(n_segs + 4); // [lanes_cap]

    const TW* w_row = w + (long)s * V * D;
    for (int i = tid; i < n_rows; i += kThreads2) {
        const float bi = load_f(b, (long)s * V + nodes[R0 + i]);
        bl[i] = bi;
        x[i] = bi;
    }
    for (int q = tid; q < n_lanes; q += kThreads2) {
        const long g = L0 + q;
        wt[q] = load_f(w_row, (long)wsrc[g] * D + wslot[g]);
        lc[q] = loc[g];
        mk[q] = mask[g];
    }
    if (tid < 2 * kMaxCluster) flags[tid] = 0;
    if (tid == 0) {
        int n = 0;
        for (int kb = 0; kb < n_buckets; ++kb) {
            const int ra = max(row_off[kb], R0);
            const int rb = min(row_off[kb + 1], R0 + n_rows);
            if (ra < rb)
                segs[n++] = make_int4(rb - ra, width[kb],
                                      (int)(lane_off[kb]
                                            + (long)(ra - row_off[kb])
                                              * width[kb] - L0),
                                      ra - R0);
        }
        *n_segs = n;
    }
    cluster_sync();       // every rank's x and flags set before any read
    const int nseg = *n_segs;

    int k = 0, par = 0;
    for (;;) {
        const unsigned xa = smem_addr(x);
        bool ch = false;
        for (int g = 0; g < nseg; ++g) {
            const int4 sg = segs[g];
            ch |= cluster_tile_round<kMax, C>(sg.x, sg.y, sg.z, sg.w, wt, lc,
                                              mk, bl, x, xa, rank, xn, shift);
        }
        ++k;
        const int any_cta = __syncthreads_or(ch);
        if (tid < (int)n_ranks)
            st_cluster(smem_addr(flags + par * kMaxCluster + rank), tid,
                       any_cta);
        cluster_sync();   // this round's xn and flags visible everywhere
        int any = 0;
        for (unsigned r = 0; r < n_ranks; ++r)
            any |= flags[par * kMaxCluster + r];
        par ^= 1;
        if (!any || k >= max_rounds) break;
        float* t = x; x = xn; xn = t;
    }
    for (int i = tid; i < n_rows; i += kThreads2)
        store_f(out, (long)s * V + nodes[R0 + i], xn[i]);
    if (rank == 0 && tid == 0) rounds[s] = k;
    cluster_sync();       // no CTA leaves while a peer may address it
}

// dtype codes: 0 = float32, 1 = bfloat16 (w and b share one; the wrapper
// widens a bf16 operand paired with an f32 one, which is exact)
template <bool kMax, int C, class TW, class TB, class TO>
cudaError_t launch_padded(const void* w, const void* b, const int* nbr,
                          const uint8_t* mask, void* out, int* rounds, int S,
                          int V, int D, float shift, int max_rounds,
                          float* b32, cudaStream_t stream) {
    size_t smem = 2 * sizeof(float) * (size_t)V;
    auto kern = edge_rounds_kernel<kMax, C, TW, TB, TO>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<S, kThreads, smem, stream>>>(
        (const TW*)w, (const TB*)b, nbr, mask, (TO*)out, rounds, V, D,
        shift, max_rounds, b32);
    return cudaGetLastError();
}

struct BucketArgs {
    const int *nodes, *loc, *wsrc, *wslot;
    const uint8_t* mask;
    const int* row_off;
    const long* lane_off;
    const int* width;
    int n_buckets;
    const int* row_start;
    const long* lane_start;
    int cluster, rows_cap, lanes_cap;
};

template <bool kMax, int C, class TW, class TB, class TO>
cudaError_t launch_bucketed(const void* w, const void* b,
                            const BucketArgs& a, void* out, int* rounds,
                            int S, int V, int D, float shift, int max_rounds,
                            cudaStream_t stream) {
    auto kern = edge_rounds_bucketed_kernel<kMax, C, TW, TB, TO>;
    const size_t smem = k2_smem_bytes(a.rows_cap, a.lanes_cap);
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (a.cluster > 8) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(S * a.cluster), 1, 1);
    cfg.blockDim = dim3(k2_threads(C), 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, (const TW*)w, (const TB*)b, a.nodes,
                           a.loc, a.wsrc, a.wslot, a.mask, a.row_off,
                           a.lane_off, a.width, a.n_buckets, a.row_start,
                           a.lane_start, (TO*)out, rounds, V, D, shift,
                           max_rounds, a.rows_cap, a.lanes_cap);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace

// dispatch on reduce (M), slots a lane (cw: 1..32) and dtype (dt);
// LAUNCH is a function template <kMax, C, TW, TB, TO>
#define ER_DTYPES(LAUNCH, M, C, ...)                                      \
    if (dt == 0)                                                          \
        return (int)LAUNCH<M, C, float, float, float>(__VA_ARGS__);       \
    if (dt == 1)                                                          \
        return (int)LAUNCH<M, C, __nv_bfloat16, __nv_bfloat16,            \
                           __nv_bfloat16>(__VA_ARGS__);                   \
    return (int)cudaErrorInvalidValue;
#define ER_WIDTHS(LAUNCH, M, ...)                                         \
    switch (cw) {                                                         \
        case 1: { ER_DTYPES(LAUNCH, M, 1, __VA_ARGS__) }                  \
        case 2: { ER_DTYPES(LAUNCH, M, 2, __VA_ARGS__) }                  \
        case 4: { ER_DTYPES(LAUNCH, M, 4, __VA_ARGS__) }                  \
        case 8: { ER_DTYPES(LAUNCH, M, 8, __VA_ARGS__) }                  \
        case 16: { ER_DTYPES(LAUNCH, M, 16, __VA_ARGS__) }                \
        case 32: { ER_DTYPES(LAUNCH, M, 32, __VA_ARGS__) }                \
        default: return (int)cudaErrorInvalidValue;                       \
    }
#define ER_DISPATCH(LAUNCH, ...)                                          \
    if (reduce_max) {                                                     \
        ER_WIDTHS(LAUNCH, true, __VA_ARGS__)                              \
    } else {                                                              \
        ER_WIDTHS(LAUNCH, false, __VA_ARGS__)                             \
    }

extern "C" {

// One launch of the padded fixed point (K1), one CTA per task row.  `cw`
// is the lanes-per-row count of the tile rounded up to a power of two
// divided by 32 (1 when narrower); the wrapper computes it.  `dt` is the
// dtype code of w and b; b32 is [S, V] f32 scratch.  Returns
// cudaGetLastError() of the launch.
int edge_rounds_launch(int reduce_max, int cw, int dt, const void* w,
                       const void* b, const void* nbr, const void* mask,
                       void* out, void* rounds, int S, int V, int D,
                       float shift, int max_rounds, void* b32,
                       void* stream) {
    ER_DISPATCH(launch_padded, w, b, (const int*)nbr, (const uint8_t*)mask,
                out, (int*)rounds, S, V, D, shift, max_rounds, (float*)b32,
                (cudaStream_t)stream)
    return (int)cudaErrorInvalidValue;
}

// One launch of the bucketed fixed point (K2), one cluster of `cluster`
// CTAs (1, 2, 4, 8 or 16) per task row, on the rank plan of
// kernels/edge_rounds.py:cluster_plan (row_start, lane_start [cluster+1],
// loc [lanes]; rows_cap and lanes_cap, multiples of 4, the most rows and
// lanes of a rank).  Returns the launch's error, or cudaGetLastError().
int edge_rounds_bucketed_launch(
        int reduce_max, int cw, int dt, const void* w, const void* b,
        const void* nodes, const void* loc, const void* wsrc,
        const void* wslot, const void* mask, const void* row_off,
        const void* lane_off, const void* width, int n_buckets,
        const void* row_start, const void* lane_start, int cluster,
        int rows_cap, int lanes_cap, void* out, void* rounds, int S, int V,
        int D, float shift, int max_rounds, void* stream) {
    if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1))
            || n_buckets > kMaxSegs || rows_cap % 4 || lanes_cap % 4)
        return (int)cudaErrorInvalidValue;
    const BucketArgs a{(const int*)nodes, (const int*)loc, (const int*)wsrc,
                       (const int*)wslot, (const uint8_t*)mask,
                       (const int*)row_off, (const long*)lane_off,
                       (const int*)width, n_buckets, (const int*)row_start,
                       (const long*)lane_start, cluster, rows_cap,
                       lanes_cap};
    ER_DISPATCH(launch_bucketed, w, b, a, out, (int*)rounds, S, V, D, shift,
                max_rounds, (cudaStream_t)stream)
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#undef ER_DISPATCH
#undef ER_WIDTHS
#undef ER_DTYPES
