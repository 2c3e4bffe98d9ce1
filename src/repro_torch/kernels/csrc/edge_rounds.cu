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
// Both kernels run one thread-block cluster of c CTAs per task row.  The
// row's nodes are cut into c contiguous ranges; rank r keeps its nodes'
// x, next x and inject in shared memory and, where they fit, its lanes'
// weights, packed neighbours and masks too, gathered once a launch and
// kept for every round.  A round: each CTA folds its rows from the
// current x of any rank (its own by ld.shared, a peer's by
// ld.shared::cluster through mapa), writes their next x into its own
// buffer, stores its change flag into every rank's flag slots, and the
// cluster barrier (release / acquire) separates the Jacobi rounds.  A row
// stops as soon as ITS state stops changing: rounds past a row's exact
// fixed point reproduce it, so this equals the reference's shared exit;
// the launch's round count is the max over rows (taken by the wrapper).
//
// K1 (padded): node i's lanes are the row [i·D, (i+1)·D) of the tile, so
// the plan is arithmetic: rank r owns nodes [⌈rV/c⌉, ⌈(r+1)V/c⌉) and node
// j lives on rank ⌊jc/V⌋ (kernels/edge_rounds.py:k1_plan picks c and
// whether the tiles fit in shared memory; where they do not fit even a
// cluster of 16 CTAs, as for ba_10000's padded [10⁴, 277] tiles, each
// round reads them from L2 instead, and the state still lives in the
// cluster).  At sw_1000 (V = 1000, D = 14) a row's 14,000 lanes and its
// state take 69 KB a CTA at c = 2.
//
// K2 (bucketed): the row's bucket rows, laid end to end, are cut into c
// ranges balanced by lanes on the host (kernels/edge_rounds.py:
// cluster_plan, which packs every lane's neighbour as owner rank |
// owner-local row << 4); c from the shapes: 8 at ba_10000's S = 16, 4
// for its stacked taint pair.
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
// kernels are bound instead by a round's latency: each warp's chain of
// dependent shared (and distributed shared) loads and shuffles over its
// share of the rows, then the cluster barrier.  Spreading a row over c
// CTAs cuts the chain c-fold.  A V whose state does not fit the largest
// cluster is refused rather than served by a second path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;
constexpr int kMaxSegs = 32;      // buckets a K2 launch may have

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

// Threads a CTA: 16 warps; 8 where a lane holds 32 slots (tiles wider
// than 512), so that the fold's registers fit without spilling
__host__ __device__ constexpr int cluster_threads(int C) {
    return C >= 32 ? 256 : 512;
}

// K1's lane-local fold of C slots, fold_reduce's halving order written as
// a tree over the slot indices (no array to keep): the value of slots
// {c + s·k} is op(value of {c + 2s·k}, value of {c + s + 2s·k}).
template <bool kMax, int C, int c, int s, class Leaf>
__device__ __forceinline__ float slot_fold(const Leaf& leaf) {
    if constexpr (s >= C) {
        return leaf(c);
    } else {
        return op<kMax>(slot_fold<kMax, C, c, 2 * s>(leaf),
                        slot_fold<kMax, C, c + s, 2 * s>(leaf));
    }
}

// Slot c of a K1 lane: lane l of its node's group holds slots l + g·c.
// A padding slot (past the tile width, or of a row past the last) reads
// a live lane of the tile, so that no slot branches, and folds in 0.
template <class MsgFn>
struct SlotMsg {
    const MsgFn& msg;
    int base, width, l, g;
    bool live;
    __device__ __forceinline__ float operator()(int c) const {
        const int e = l + g * c;
        const float m = msg(base + min(e, width - 1));
        return (live && e < width) ? m : 0.0f;
    }
};

// One K1 round over this CTA's `rows` nodes of `width` lanes (node r's
// lanes from r·width, its state at local row r); msg(q) is lane q's
// message.  A node's padded width P is split over g = P / C lanes, 32/g
// nodes a warp, lane l of the group holding slots l, l+g, ...,
// l+(C-1)g: the lane-local fold takes the halvings with strides >= g and
// the shuffles those below, which is fold_reduce's order.  Returns
// whether a node's state changed.
template <bool kMax, int C, int kThreads, class MsgFn>
__device__ __forceinline__ bool fold_nodes(int rows, int width, int g,
                                           const MsgFn& msg,
                                           const float* __restrict__ bl,
                                           const float* __restrict__ x,
                                           float* __restrict__ xn) {
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int per_warp = 32 / g, sub = lane / g, l = lane % g;
    bool changed = false;
    for (int r0 = warp * per_warp; r0 < rows; r0 += kWarps * per_warp) {
        const int r = r0 + sub;
        const SlotMsg<MsgFn> leaf{msg, min(r, rows - 1) * width, width, l,
                                  g, r < rows};
        float v = slot_fold<kMax, C, 0, 1>(leaf);
        for (int off = g / 2; off >= 1; off >>= 1)
            v = op<kMax>(v, __shfl_down_sync(kFull, v, off, g));
        if (l == 0 && r < rows) {
            const float y = op<kMax>(bl[r], v);
            changed |= (y != x[r]);
            xn[r] = y;
        }
    }
    return changed;
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
__device__ __forceinline__ void st_cluster(unsigned addr, unsigned rank,
                                           int v) {
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(addr), "r"(rank));
    asm volatile("st.shared::cluster.s32 [%0], %1;"
                 :: "r"(remote), "r"(v) : "memory");
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
// x of the node behind a packed neighbour: from this CTA's own x when it
// owns the node, else from the owner's (`xa`: the shared address of this
// round's x buffer, laid out alike on every rank)
__device__ __forceinline__ float gather(const float* x, unsigned xa,
                                        int loc, unsigned rank) {
    const unsigned r = (unsigned)loc & 15u, off = (unsigned)(loc >> 4);
    return r == rank ? x[off] : ld_cluster(xa + 4u * off, r);
}
// The same, predicated rather than branched (K1: no slot of a lane
// branches, so its C slots stay in registers).
__device__ __forceinline__ float gather_pred(unsigned xa, int loc,
                                             unsigned rank) {
    const unsigned r = (unsigned)loc & 15u;
    const unsigned a = xa + 4u * (unsigned)(loc >> 4);
    float v;
    asm volatile("{\n\t.reg .pred own;\n\t.reg .u32 ra;\n\t"
                 "setp.eq.u32 own, %1, %2;\n\t"
                 "@own ld.shared.f32 %0, [%3];\n\t"
                 "@!own mapa.shared::cluster.u32 ra, %3, %1;\n\t"
                 "@!own ld.shared::cluster.f32 %0, [ra];\n\t}"
                 : "=f"(v) : "r"(r), "r"(rank), "r"(a));
    return v;
}

// K1's lane messages with the lanes in shared memory: weight, packed
// neighbour and mask of lane q.
struct SmemLanes {
    const float* wt;
    const int* lc;
    const uint8_t* mk;
    unsigned xa, rank;
    float shift;
    __device__ __forceinline__ float operator()(int q) const {
        return message(wt[q], mk[q] != 0, gather_pred(xa, lc[q], rank),
                       shift);
    }
};

// End of one round, for every CTA of the cluster: OR this CTA's change
// flag into every rank's slot of this round's parity, wait at the cluster
// barrier, and return whether any rank changed.
__device__ __forceinline__ int cluster_any(bool ch, int* flags, int par,
                                           unsigned rank, unsigned n_ranks) {
    const int any_cta = __syncthreads_or(ch);
    if (threadIdx.x < n_ranks)
        st_cluster(smem_addr(flags + par * kMaxCluster + rank), threadIdx.x,
                   any_cta);
    cluster_sync();       // this round's xn and flags visible everywhere
    int any = 0;
    for (unsigned r = 0; r < n_ranks; ++r)
        any |= flags[par * kMaxCluster + r];
    return any;
}

// ------------------------------------------------------------ padded (K1)
// K1's arithmetic plan: rank r of c owns nodes [k1_row(r), k1_row(r+1)),
// k1_row(r) = ⌈rV/c⌉; node j lives on rank ⌊jc/V⌋ (the largest r with
// rV <= jc), at its row j - k1_row(r) there.
// (32-bit: V·c stays below 2^31 for every V whose state fits a cluster)
__device__ __forceinline__ int k1_row(int r, int V, int c) {
    return (int)(((unsigned)(r * V) + c - 1) / (unsigned)c);
}
__device__ __forceinline__ int k1_pack(int j, int V, int c) {
    j = min(max(j, 0), V - 1);          // a slot's index is a node's
    const int r = (int)((unsigned)(j * c) / (unsigned)V);
    return r | ((j - k1_row(r, V, c)) << 4);
}

// K1's lane messages with the lanes left in global memory (tiles that
// fit no cluster): the rank's rows of w, nbr and mask, read every round.
template <class TW>
struct GlobalLanes {
    const TW* w;
    const int* nbr;
    const uint8_t* mask;
    unsigned xa, rank;
    float shift;
    int V, c;
    __device__ __forceinline__ float operator()(int q) const {
        return message(load_f(w, q), mask[q] != 0,
                       gather_pred(xa, k1_pack(nbr[q], V, c), rank), shift);
    }
};

size_t k1_smem_bytes(int rows_cap, int D, int tiles) {
    const size_t lanes = tiles ? (size_t)rows_cap * D : 0;
    return sizeof(float) * (3 * (size_t)rows_cap + 2 * lanes
                            + 2 * kMaxCluster) + lanes;
}

// One cluster of c CTAs per task row.  kTiles: the rank's lanes (weights
// w[s, i, e], neighbours packed by k1_pack, masks) are gathered into
// shared memory once; else every round reads them from global memory.
// A node's padded width P is folded on g = P / C lanes, C slots a lane
// (C from the wrapper: P / 32 for tiles of 32 or more, more than one
// slot a lane below that, so that a warp folds 32/g nodes at once with C
// independent gathers a lane).
template <bool kMax, int C, bool kTiles, class TW, class TB, class TO>
__global__ void __launch_bounds__(cluster_threads(C), 1)
edge_rounds_kernel(const TW* __restrict__ w, const TB* __restrict__ b,
                   const int* __restrict__ nbr,
                   const uint8_t* __restrict__ mask, TO* __restrict__ out,
                   int* __restrict__ rounds, int V, int D, float shift,
                   int max_rounds, int rows_cap) {
    constexpr int kThreads = cluster_threads(C);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const unsigned n_ranks = cluster_ctas(), rank = cluster_rank();
    const int c = (int)n_ranks;
    const int s = blockIdx.x / n_ranks, tid = threadIdx.x;
    const int R0 = k1_row(rank, V, c);
    const int n_rows = k1_row(rank + 1, V, c) - R0;
    const long L0 = (long)R0 * D;
    const int n_lanes = n_rows * D;
    int P = 1;
    while (P < D) P <<= 1;
    const int g = P > C ? P / C : 1;
    // rows_cap is a multiple of 4: every part 16-byte aligned
    const int lanes_cap = kTiles ? rows_cap * D : 0;
    float* x = reinterpret_cast<float*>(smem_raw);   // [rows_cap]
    float* xn = x + rows_cap;                         // [rows_cap]
    float* bl = xn + rows_cap;                        // [rows_cap]
    float* wt = bl + rows_cap;                        // [lanes_cap]
    int* lc = reinterpret_cast<int*>(wt + lanes_cap); // [lanes_cap]
    int* flags = lc + lanes_cap;                      // [2][kMaxCluster]
    uint8_t* mk = reinterpret_cast<uint8_t*>(flags + 2 * kMaxCluster);

    const TW* w_row = w + (long)s * V * D + L0;
    const int* nbr_r = nbr + L0;
    const uint8_t* mask_r = mask + L0;
    for (int i = tid; i < n_rows; i += kThreads) {
        const float bi = load_f(b, (long)s * V + R0 + i);
        bl[i] = bi;
        x[i] = bi;
    }
    if (kTiles) {
        for (int q = tid; q < n_lanes; q += kThreads) {
            wt[q] = load_f(w_row, q);
            lc[q] = k1_pack(nbr_r[q], V, c);
            mk[q] = mask_r[q];
        }
    }
    if (tid < 2 * kMaxCluster) flags[tid] = 0;
    cluster_sync();       // every rank's x and flags set before any read

    int k = 0, par = 0;
    for (;;) {
        const unsigned xa = smem_addr(x);
        bool ch;
        if (kTiles) {
            const SmemLanes msg{wt, lc, mk, xa, rank, shift};
            ch = fold_nodes<kMax, C, kThreads>(n_rows, D, g, msg, bl, x,
                                               xn);
        } else {
            const GlobalLanes<TW> msg{w_row, nbr_r, mask_r, xa, rank, shift,
                                      V, c};
            ch = fold_nodes<kMax, C, kThreads>(n_rows, D, g, msg, bl, x,
                                               xn);
        }
        ++k;
        const int any = cluster_any(ch, flags, par, rank, n_ranks);
        par ^= 1;
        if (!any || k >= max_rounds) break;
        float* t = x; x = xn; xn = t;
    }
    for (int i = tid; i < n_rows; i += kThreads)
        store_f(out, (long)s * V + R0 + i, xn[i]);
    if (rank == 0 && tid == 0) rounds[s] = k;
    cluster_sync();       // no CTA leaves while a peer may address it
}

// ---------------------------------------------------------- bucketed (K2)
// Rank r owns the nodes of rows [row_start[r], row_start[r+1]) of the
// buckets laid end to end and keeps, in its shared memory, their x, next
// x and inject in row order, and its lanes' weights w[s, wsrc, wslot],
// packed neighbours and masks.
size_t k2_smem_bytes(int rows_cap, int lanes_cap) {
    return sizeof(float) * (3 * (size_t)rows_cap + 2 * (size_t)lanes_cap
                            + 2 * kMaxCluster)
        + sizeof(int4) * kMaxSegs + 16 + (size_t)lanes_cap;
}

// One round over one bucket's rows on this rank (`rows` rows of `width`
// lanes from rank-local lane `lane0` and row `row0`), on the tiles in
// shared memory: a width of 32 or more on C slots a lane (lane_fold, then
// the shuffles; slots past the width fold in as exact zeros), a narrower
// one on one slot a lane.
template <bool kMax, int C>
__device__ bool cluster_tile_round(int rows, int width, int lane0, int row0,
                                   const float* __restrict__ wt,
                                   const int* __restrict__ loc,
                                   const uint8_t* __restrict__ mk,
                                   const float* __restrict__ bl,
                                   const float* __restrict__ x, unsigned xa,
                                   unsigned rank, float* __restrict__ xn,
                                   float shift) {
    constexpr int kWarps2 = cluster_threads(C) / 32;
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
__global__ void __launch_bounds__(cluster_threads(C), 1)
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
    constexpr int kThreads = cluster_threads(C);
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
    for (int i = tid; i < n_rows; i += kThreads) {
        const float bi = load_f(b, (long)s * V + nodes[R0 + i]);
        bl[i] = bi;
        x[i] = bi;
    }
    for (int q = tid; q < n_lanes; q += kThreads) {
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
        const int any = cluster_any(ch, flags, par, rank, n_ranks);
        par ^= 1;
        if (!any || k >= max_rounds) break;
        float* t = x; x = xn; xn = t;
    }
    for (int i = tid; i < n_rows; i += kThreads)
        store_f(out, (long)s * V + nodes[R0 + i], xn[i]);
    if (rank == 0 && tid == 0) rounds[s] = k;
    cluster_sync();       // no CTA leaves while a peer may address it
}

// Launch `kern` as S clusters of `cluster` CTAs with `smem` bytes each.
template <class Kern, class... Args>
cudaError_t launch_clusters(Kern kern, int C, int S, int cluster,
                            size_t smem, cudaStream_t stream,
                            Args... args) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (cluster > 8) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(S * cluster), 1, 1);
    cfg.blockDim = dim3(cluster_threads(C), 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, args...);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

struct PaddedArgs {
    const int* nbr;
    const uint8_t* mask;
    int cluster, rows_cap, tiles;
};

// dtype codes: 0 = float32, 1 = bfloat16 (w and b share one; the wrapper
// widens a bf16 operand paired with an f32 one, which is exact)
template <bool kMax, int C, class TW, class TB, class TO>
cudaError_t launch_padded(const void* w, const void* b, const PaddedArgs& a,
                          void* out, int* rounds, int S, int V, int D,
                          float shift, int max_rounds, cudaStream_t stream) {
    const size_t smem = k1_smem_bytes(a.rows_cap, D, a.tiles);
    using Kern = decltype(&edge_rounds_kernel<kMax, C, true, TW, TB, TO>);
    const Kern kern = a.tiles ? &edge_rounds_kernel<kMax, C, true, TW, TB, TO>
                              : &edge_rounds_kernel<kMax, C, false, TW, TB, TO>;
    return launch_clusters(kern, C, S, a.cluster, smem, stream,
                           (const TW*)w, (const TB*)b, a.nbr, a.mask,
                           (TO*)out, rounds, V, D, shift, max_rounds,
                           a.rows_cap);
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
    return launch_clusters(
        edge_rounds_bucketed_kernel<kMax, C, TW, TB, TO>, C, S, a.cluster,
        k2_smem_bytes(a.rows_cap, a.lanes_cap), stream, (const TW*)w,
        (const TB*)b, a.nodes, a.loc, a.wsrc, a.wslot, a.mask, a.row_off,
        a.lane_off, a.width, a.n_buckets, a.row_start, a.lane_start,
        (TO*)out, rounds, V, D, shift, max_rounds, a.rows_cap, a.lanes_cap);
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

// One launch of the padded fixed point (K1), one cluster of `cluster`
// CTAs (1, 2, 4, 8 or 16) per task row on the arithmetic plan
// (kernels/edge_rounds.py:k1_plan; rows_cap, a multiple of 4, at least
// ⌈V/cluster⌉; tiles = 1 keeps the lanes in shared memory).  `cw` is the
// lanes-per-row count of the tile rounded up to a power of two divided
// by 32 (1 when narrower); `dt` the dtype code of w and b.  Returns the
// launch's error, or cudaGetLastError().
int edge_rounds_launch(int reduce_max, int cw, int dt, const void* w,
                       const void* b, const void* nbr, const void* mask,
                       void* out, void* rounds, int S, int V, int D,
                       float shift, int max_rounds, int cluster,
                       int rows_cap, int tiles, void* stream) {
    if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1))
            || rows_cap % 4 || rows_cap * (long)cluster < V)
        return (int)cudaErrorInvalidValue;
    const PaddedArgs a{(const int*)nbr, (const uint8_t*)mask, cluster,
                       rows_cap, tiles};
    ER_DISPATCH(launch_padded, w, b, a, out, (int*)rounds, S, V, D, shift,
                max_rounds, (cudaStream_t)stream)
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
