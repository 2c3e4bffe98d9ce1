// One-token grouped-query attention against a KV cache (decode).
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/decode_attention.py : decode_attention
// and computes its function (the plain version is
// kernels/ref.py:decode_attention_ref): for batch row b and KV head h,
// the G query rows of that head attend to cache positions
// [0, lengths[b]) with softmax(q kᵀ / √hd); float32 scores,
// probabilities and accumulators, normalised once at the end, one cast
// of the output to the input type (float32 or bfloat16).
//
// Bound: bytes.  A call must read lengths[b]·hd K and V values per (b,
// h) and does 4·G multiply-adds per value pair, 1-2 query rows per KV
// head, so tensor cores would idle 62 of their 64 rows.  At Qwen3-0.6B's
// decode (q [8, 8, 2, 128] bf16 against an [8, 1024, 8, 128] cache,
// 3,728 valid positions) that is 15.3 MB, 4.6 µs at 3.35 TB/s; at
// OLMoE's (q [8, 16, 1, 128]) twice the bytes.  So the kernel has to keep
// every SM pulling bytes, whatever B and the lengths are.
//
// Design, on CUDA cores:
//
// * The sequence is split across CTAs.  The grid is (KV, B, n_splits ·
//   ceil(G / MG)); CTA (h, b, split s) takes positions [s·split,
//   (s+1)·split) of the cache capacity S, where the wrapper picks split
//   (a power of two, 16-64) from B, KV and S alone so that the grid has
//   a CTA for every SM at B = 1 too (no host read of lengths: the launch
//   is capturable in a CUDA graph).  A CTA whose split starts at or past
//   lengths[b] exits at once: it loads nothing and takes no part in the
//   merge, which counts only the n_live = ceil(lengths[b] / split) live
//   splits.
// * In a CTA of 4 warps, a cache row of hd values is LPR lanes of 16-byte
//   loads (bf16 at hd 128: 16 lanes, two rows a warp; float32: 32 lanes,
//   one row).  Each lane issues the loads of U warp steps (up to 16 rows
//   of K and V a warp) before it uses any, so a warp keeps U·2 16-byte
//   loads in flight; then one interleaved butterfly of LPR lanes reduces
//   the U·MG dot products and the lane folds its U rows into its running
//   max, sum and accumulator.  A masked row gets probability 0, never
//   exp(NEG_INF - NEG_INF) = 1.
// * The CTA merges its row groups' partial softmaxes in a fixed order
//   through shared memory (a group that saw no position has sum 0 and
//   weight 0).  With one live split that is the output; otherwise it
//   writes one partial (max, sum, hd accumulators per query row) to a
//   float32 scratch the wrapper allocates.
// * The partials are merged in split order by the last live CTA of each
//   (KV head, batch row, query group): each takes a ticket from an atomic
//   counter after its partial is visible; the one that draws n_live - 1
//   loads every live partial's (max, sum) and its first accumulators
//   together, weighs split s by exp(m_s - M) (0 for an empty partial),
//   writes the output and resets the counter to 0 for the next call.
//   One launch, no second kernel: the decode step keeps one launch a
//   layer, and no launch waits on another.  The order of the sums is
//   fixed, so the result does not depend on which CTA comes last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

struct Strides {   // element strides of three leading axes (see launch)
    long a, b, c;
};

// The 16 bytes of elements [d0, d0 + 16 / sizeof(T)) of one cache row,
// zero past hd: one vector load when the row is 16-byte aligned and hd a
// multiple of the vector (vec), element by element otherwise.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int d0, int hd,
                                            bool vec) {
    constexpr int N = 16 / sizeof(T);
    if (d0 >= hd) return make_uint4(0u, 0u, 0u, 0u);
    if (vec) return __ldg(reinterpret_cast<const uint4*>(row + d0));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < N; ++e) {
        if (d0 + e >= hd) break;
        if constexpr (sizeof(T) == 2)
            w[e / 2] |= (uint32_t)__bfloat16_as_ushort(row[d0 + e])
                << (16 * (e & 1));
        else
            w[e] = __float_as_uint(row[d0 + e]);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 16 bytes as float32 values, exactly
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[16 / sizeof(T)]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 2) {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        } else {
            f[i] = __uint_as_float(w[i]);
        }
    }
}

// T: cache type; LPR: lanes a cache row takes (a power of two, 4-32);
// MG: query rows a CTA takes (1, 2, 4 or 8).  At MG <= 2 (the serving
// path) the registers are held to 128, so 4 CTAs share an SM.
template <typename T, int LPR, int MG>
__global__ void __launch_bounds__(kThreads, MG <= 2 ? 4 : 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    float* __restrict__ part, int* __restrict__ tickets,
                    Strides qs, Strides ks, Strides vs, Strides os, int G,
                    int hd, int S, int split, int n_splits, float scale,
                    int vec) {
    constexpr int N = 16 / sizeof(T);     // elements a lane loads at once
    constexpr int RPW = 32 / LPR;         // cache rows a warp step covers
    constexpr int NGRP = kWarps * RPW;    // partial softmaxes in a CTA
    constexpr int HDP = LPR * N;          // head dims a row's lanes cover
    constexpr int kU = MG <= 2 ? 8 : (MG == 4 ? 4 : 2);   // steps in flight
    constexpr int kStep = kWarps * RPW;   // rows between a warp's steps
    constexpr int kBuf = NGRP * MG * HDP > 2 * MG * kMaxSplits
        ? NGRP * MG * HDP : 2 * MG * kMaxSplits;
    __shared__ float grp_m[NGRP][MG], grp_l[NGRP][MG];
    __shared__ float buf[kBuf];   // group accumulators, then split weights
    __shared__ float tot_l[MG];
    __shared__ int is_last;

    const int n_gz = (G + MG - 1) / MG;
    const int kvh = blockIdx.x, b = blockIdx.y;
    const int gz = blockIdx.z % n_gz, sp = blockIdx.z / n_gz;
    const int g0 = gz * MG, ng = min(MG, G - g0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane / LPR, d0 = (lane % LPR) * N;
    const int len = min(lengths[b], S);
    const int n_live = (len + split - 1) / split;   // splits with positions
    if (sp >= n_live) return;
    const int p0 = sp * split, p1 = min(p0 + split, len);
    // partial (b, kvh, gz, sp): MG·2 of (max, sum), then MG·hd sums
    const long set = ((long)b * gridDim.x + kvh) * n_gz + gz;
    const long stride = (long)MG * (hd + 2);
    float* mine = part + (set * n_splits + sp) * stride;

    float qf[MG][N], m[MG], l[MG], acc[MG][N];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
        m[g] = kNegInf;
        l[g] = 0.0f;
        const uint4 qc = g < ng
            ? load_chunk(q + b * qs.a + kvh * qs.b + (g0 + g) * qs.c, d0, hd,
                         vec)
            : make_uint4(0u, 0u, 0u, 0u);
        unpack<T>(qc, qf[g]);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[g][e] = 0.0f;
    }
    const T* kb = kc + b * ks.a + kvh * ks.c;   // + position·ks.b
    const T* vb = vc + b * vs.a + kvh * vs.c;
    // warp step u of a pass covers rows base + u·kStep + [0, RPW)
    for (int base = p0 + warp * RPW; base < p1; base += kU * kStep) {
        uint4 kr[kU], vr[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const int p = base + u * kStep + r;
            const bool ok = p < p1;
            kr[u] = ok ? load_chunk(kb + (long)p * ks.b, d0, hd, vec)
                       : make_uint4(0u, 0u, 0u, 0u);
            vr[u] = ok ? load_chunk(vb + (long)p * vs.b, d0, hd, vec)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
        float s[kU][MG];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            float kf[N];
            unpack<T>(kr[u], kf);
#pragma unroll
            for (int g = 0; g < MG; ++g) {
                float t = 0.0f;
#pragma unroll
                for (int e = 0; e < N; ++e) t = fmaf(qf[g][e], kf[e], t);
                s[u][g] = t;
            }
        }
#pragma unroll
        for (int off = LPR / 2; off >= 1; off >>= 1)
#pragma unroll
            for (int u = 0; u < kU; ++u)
#pragma unroll
                for (int g = 0; g < MG; ++g)
                    s[u][g] += __shfl_xor_sync(kFull, s[u][g], off);
        // online softmax over this pass's rows; masked rows weigh 0
        float pr[kU][MG];
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            float mx = m[g];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const bool ok = base + u * kStep + r < p1;
                s[u][g] = ok ? s[u][g] * scale : kNegInf;
                mx = fmaxf(mx, s[u][g]);
            }
            const float alpha = expf(m[g] - mx);
            float ps = 0.0f;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const bool ok = base + u * kStep + r < p1;
                pr[u][g] = ok ? expf(s[u][g] - mx) : 0.0f;
                ps += pr[u][g];
            }
            l[g] = l[g] * alpha + ps;
            m[g] = mx;
#pragma unroll
            for (int e = 0; e < N; ++e) acc[g][e] *= alpha;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            float vf[N];
            unpack<T>(vr[u], vf);
#pragma unroll
            for (int g = 0; g < MG; ++g)
#pragma unroll
                for (int e = 0; e < N; ++e)
                    acc[g][e] = fmaf(pr[u][g], vf[e], acc[g][e]);
        }
    }

    // merge the CTA's row groups in a fixed order
    const int grp = warp * RPW + r;
#pragma unroll
    for (int g = 0; g < MG; ++g) {
        if (d0 == 0) {
            grp_m[grp][g] = m[g];
            grp_l[grp][g] = l[g];
        }
#pragma unroll
        for (int e = 0; e < N; ++e)
            buf[(grp * MG + g) * HDP + d0 + e] = acc[g][e];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < ng * hd; idx += kThreads) {
        const int g = idx / hd, d = idx - g * hd;
        float mx = kNegInf;
        for (int j = 0; j < NGRP; ++j)
            if (grp_l[j][g] > 0.0f) mx = fmaxf(mx, grp_m[j][g]);
        float tot = 0.0f, a = 0.0f;
        for (int j = 0; j < NGRP; ++j) {
            if (grp_l[j][g] > 0.0f) {
                const float w = expf(grp_m[j][g] - mx);
                tot += w * grp_l[j][g];
                a += w * buf[(j * MG + g) * HDP + d];
            }
        }
        if (n_live == 1) {   // the whole row: the output itself
            o[b * os.a + kvh * os.b + (g0 + g) * os.c + d] =
                from_f<T>(a / fmaxf(tot, 1e-30f));
            continue;
        }
        mine[2 * MG + g * hd + d] = a;
        if (d == 0) {
            mine[2 * g] = mx;
            mine[2 * g + 1] = tot;
        }
    }
    if (n_live == 1) return;

    // the last live CTA of (b, kvh, gz) to finish merges the live splits
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        is_last = atomicAdd(tickets + set, 1) == n_live - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const float* all = part + set * n_splits * stride;
    float* w_m = buf;                      // [MG][n_splits] maxima,
    float* w_l = buf + MG * kMaxSplits;    // then weights; sums
    // this thread's (query row, dim) pairs, at most kPairs of them, and
    // their first kBatch splits' sums, loaded beside the (max, sum) pairs
    // (a live split's sum is positive, so none is loaded in vain)
    constexpr int kPairs = (MG * 128 + kThreads - 1) / kThreads;
    constexpr int kBatch = 16 / kPairs;
    float x[kPairs][kBatch];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
        const int idx = threadIdx.x + j * kThreads, g = idx / hd;
        const float* src = all + 2 * MG + idx;   // g·hd + d == idx
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
            x[j][i] = g < ng && i < n_live ? __ldcg(src + i * stride) : 0.0f;
    }
    for (int idx = threadIdx.x; idx < ng * n_live; idx += kThreads) {
        const int g = idx / n_live, s = idx - g * n_live;
        w_m[g * kMaxSplits + s] = __ldcg(all + s * stride + 2 * g);
        w_l[g * kMaxSplits + s] = __ldcg(all + s * stride + 2 * g + 1);
    }
    __syncthreads();
    // one warp a query row: the max over the live splits, each split's
    // weight exp(m_s - M) (0 for an empty one) and the weighted sum
    for (int g = warp; g < ng; g += kWarps) {
        float* wm = w_m + g * kMaxSplits;
        const float* wl = w_l + g * kMaxSplits;
        float mx = kNegInf, tot = 0.0f;
        for (int s = lane; s < n_live; s += 32)
            if (wl[s] > 0.0f) mx = fmaxf(mx, wm[s]);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        for (int s = lane; s < n_live; s += 32) {
            const float w = wl[s] > 0.0f ? expf(wm[s] - mx) : 0.0f;
            wm[s] = w;
            tot += w * wl[s];
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
            tot += __shfl_xor_sync(kFull, tot, off);
        if (lane == 0) tot_l[g] = fmaxf(tot, 1e-30f);
    }
    __syncthreads();
    // the output: the splits' sums in split order, kBatch loads in flight
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
        const int idx = threadIdx.x + j * kThreads, g = idx / hd;
        if (g >= ng) break;
        const float* w = w_m + g * kMaxSplits;
        const float* src = all + 2 * MG + idx;
        float a = 0.0f;
        for (int s0 = 0; s0 < n_live; s0 += kBatch) {
            if (s0 > 0) {
#pragma unroll
                for (int i = 0; i < kBatch; ++i)
                    x[j][i] = s0 + i < n_live
                        ? __ldcg(src + (s0 + i) * stride) : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < kBatch; ++i)
                if (s0 + i < n_live) a += w[s0 + i] * x[j][i];
        }
        o[b * os.a + kvh * os.b + (g0 + g) * os.c + idx - g * hd] =
            from_f<T>(a / tot_l[g]);
    }
    if (threadIdx.x == 0) tickets[set] = 0;
}

template <typename T, int LPR, int MG>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lengths, void* o, void* part, void* tickets,
                   int B, int KV, int G, int hd, int S, int split,
                   int n_splits, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, int vec, cudaStream_t stream) {
    const dim3 grid(KV, B, n_splits * ((G + MG - 1) / MG));
    decode_split_kernel<T, LPR, MG><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, (const int*)lengths,
        (T*)o, (float*)part, (int*)tickets, qs, ks, vs, os, G, hd, S, split,
        n_splits, scale, vec);
    return cudaGetLastError();
}

#define DECODE_ARGS q, kc, vc, lengths, o, part, tickets, B, KV, G, hd, S, \
    split, n_splits, qs, ks, vs, os, scale, vec, stream

template <typename T, int LPR>
cudaError_t launch_g(int mg, const void* q, const void* kc, const void* vc,
                     const void* lengths, void* o, void* part, void* tickets,
                     int B, int KV, int G, int hd, int S, int split,
                     int n_splits, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale, int vec, cudaStream_t stream) {
    switch (mg) {
        case 1: return launch<T, LPR, 1>(DECODE_ARGS);
        case 2: return launch<T, LPR, 2>(DECODE_ARGS);
        case 4: return launch<T, LPR, 4>(DECODE_ARGS);
        case 8: return launch<T, LPR, 8>(DECODE_ARGS);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launch_t(int lpr, int mg, const void* q, const void* kc,
                     const void* vc, const void* lengths, void* o,
                     void* part, void* tickets, int B, int KV, int G, int hd,
                     int S, int split, int n_splits, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale, int vec,
                     cudaStream_t stream) {
    switch (lpr) {
        case 4: return launch_g<T, 4>(mg, DECODE_ARGS);
        case 8: return launch_g<T, 8>(mg, DECODE_ARGS);
        case 16: return launch_g<T, 16>(mg, DECODE_ARGS);
        case 32:   // float32 only: a bf16 row of hd <= 128 takes <= 16
            if constexpr (sizeof(T) == 4)
                return launch_g<T, 32>(mg, DECODE_ARGS);
            return cudaErrorInvalidValue;
        default: return cudaErrorInvalidValue;
    }
}

bool rows_aligned(const void* p, Strides st, int n) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.a % n == 0
        && st.b % n == 0 && st.c % n == 0;
}

}  // namespace

extern "C" {

// q [B, KV, G, hd] by strides (b, kv head, g); caches [B, S, KV, hd] by
// strides (b, s, kv head); o [B, KV, G, hd] by strides (b, kv head, g);
// the head dim contiguous everywhere; lengths [B] int32 >= 1.  bf16 != 0:
// q, caches and o are bfloat16, else float32.  lpr = the lanes a cache
// row takes (4, 8, 16 or 32; lpr · 16 bytes >= a row); mg = the query
// rows a CTA takes, 1, 2, 4 or 8; split and n_splits: the positions a
// CTA takes and ceil(S / split) <= 256.  part: float32 scratch of
// B·KV·ceil(G / mg)·n_splits·mg·(hd + 2); tickets: int32
// [B·KV·ceil(G / mg)], zero, left zero.  Returns cudaGetLastError() of
// the launch.
int decode_attention_launch(int bf16, int lpr, int mg, const void* q,
                            const void* kc, const void* vc,
                            const void* lengths, void* o, void* part,
                            void* tickets, int B, int KV, int G, int hd,
                            int S, int split, int n_splits, long qsb,
                            long qsk, long qsg, long ksb, long kss, long ksk,
                            long vsb, long vss, long vsk, long osb, long osk,
                            long osg, float scale, void* stream) {
    if (B == 0 || KV == 0 || G == 0) return 0;
    const int n = bf16 ? 8 : 4;   // elements in 16 bytes
    if (hd > lpr * n || n_splits < 1 || n_splits > kMaxSplits
            || (long)split * n_splits < S)
        return (int)cudaErrorInvalidValue;
    const Strides qs{qsb, qsk, qsg}, ks{ksb, kss, ksk}, vs{vsb, vss, vsk},
        os{osb, osk, osg};
    const int vec = hd % n == 0 && rows_aligned(q, qs, n)
        && rows_aligned(kc, ks, n) && rows_aligned(vc, vs, n);
    if (bf16)
        return (int)launch_t<__nv_bfloat16>(
            lpr, mg, q, kc, vc, lengths, o, part, tickets, B, KV, G, hd, S,
            split, n_splits, qs, ks, vs, os, scale, vec,
            (cudaStream_t)stream);
    return (int)launch_t<float>(
        lpr, mg, q, kc, vc, lengths, o, part, tickets, B, KV, G, hd, S,
        split, n_splits, qs, ks, vs, os, scale, vec, (cudaStream_t)stream);
}

}  // extern "C"
