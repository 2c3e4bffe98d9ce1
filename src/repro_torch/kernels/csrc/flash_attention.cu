// Causal or non-causal grouped-query attention, forward, for prefill.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/flash_attention.py : flash_attention
// and computes its function (the plain version is
// kernels/ref.py:flash_attention_ref): o = softmax(q kᵀ / √hd) v per
// query head, KV head = query head / (H / KV), future keys masked with
// the finite NEG_INF = -1e30 when causal.  Scores, the softmax and the
// output accumulator are float32; the output is normalised once at the
// end and cast once to the input type (float32 or bfloat16).
//
// Two kernels, picked by what the launch can observe:
//
// * bfloat16 with hd 64 or 128 and 16-byte aligned rows: tensor cores.
//   One CTA of 4 warps per (query tile of 64 rows, query head, batch
//   row); each warp owns 16 query rows, keeps their Q fragments in
//   registers and multiplies with mma.sync m16n8k16 (bf16 in, f32
//   accumulate): S = Q Kᵀ for a tile of 64 keys, then, after the online
//   softmax in registers, O += P V.  P is float32 there, as in the
//   Pallas kernel; it enters the bf16 mma as two bfloat16 parts, P ≈
//   hi + lo with hi = bf16(P) and lo = bf16(P - hi), so two mma per tile
//   carry it to a relative 2^-17 instead of bf16's 2^-9.  The
//   accumulator layout of S is the operand layout of P, so P never
//   leaves registers.
// * float32, or any other head dim (<= 128): CUDA cores.  One CTA of
//   256 threads per (query tile of 64, head, batch row) with Q, K, V and
//   the score tile staged in shared memory as float32; thread (ty, tx)
//   of a 16 x 16 grid owns score rows ty + 16i, columns tx + 16j, and
//   output dims tx + 16j.
//
// Both walk the keys in tiles of 64 up to the diagonal when causal
// (tiles wholly above it contribute nothing), keep a running max and
// sum per row and rescale the accumulators by exp(m_old - m_new), and
// mask the tail tiles of queries and keys, so any length works (the
// Pallas wrapper asserts S % 128 == 0).  Inputs are read and the output
// written by strides, so the model's [B, L, H, hd] activations need no
// transpose.
//
// Bound: at the prefill shapes (S <= 512, hd = 128, bf16) the bytes of
// q, k, v and o (6.3 MB at S = 512) allow 1.9 µs and the flops 1.1 µs.
// Both kernels load each tile synchronously before using it, so a CTA
// waits on global memory once a tile; double-buffered cp.async or TMA
// loads and wgmma are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kNJ = kMaxHd / 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
    return v;
}

struct Strides {   // element strides of the batch, head and sequence axes
    long b, h, s;
};

size_t smem_bytes(int hd) {
    return sizeof(float) * ((size_t)kBQ * hd + (size_t)kBK * (hd + 1)
                            + (size_t)kBK * hd + (size_t)kBQ * (kBK + 1)
                            + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int KV, int S,
                 int hd, float scale, int causal) {
    extern __shared__ float smem[];
    const int ldk = hd + 1;          // padded K rows: conflict-free reads
    const int ldp = kBK + 1;
    float* Qs = smem;                        // [kBQ][hd]
    float* Ks = Qs + kBQ * hd;               // [kBK][hd + 1]
    float* Vs = Ks + kBK * ldk;              // [kBK][hd]
    float* Ps = Vs + kBK * hd;               // [kBQ][kBK + 1]
    float* m_s = Ps + kBQ * ldp;             // running max per row
    float* l_s = m_s + kBQ;                  // running sum per row
    float* a_s = l_s + kBQ;                  // this tile's rescale

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int warp = tid >> 5, lane = tid & 31;
    const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KV);
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + kvh * ks.h;
    const T* vb = v + b * vs.b + kvh * vs.h;
    T* ob = o + b * os.b + h * os.h;

    for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
        const int r = idx / hd, d = idx - r * hd, s = q0 + r;
        Qs[idx] = s < S ? to_f(qb[s * qs.s + d]) : 0.0f;
    }
    if (tid < kBQ) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.0f;
    }
    float acc[4][kNJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.0f;

    const int kv_end = causal ? min(S, q0 + kBQ) : S;
    for (int k0 = 0; k0 < kv_end; k0 += kBK) {
        __syncthreads();   // Q staged; the previous tile fully consumed
        for (int idx = tid; idx < kBK * hd; idx += kThreads) {
            const int c = idx / hd, d = idx - c * hd, s = k0 + c;
            const bool ok = s < S;
            Ks[c * ldk + d] = ok ? to_f(kb[s * ks.s + d]) : 0.0f;
            Vs[idx] = ok ? to_f(vb[s * vs.s + d]) : 0.0f;
        }
        __syncthreads();

        // scores of rows ty + 16i against keys tx + 16j of this tile
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
        for (int d = 0; d < hd; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * hd + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j, key = k0 + c;
                const bool ok = key < S && (!causal || key <= q0 + r);
                Ps[r * ldp + c] = ok ? sc[i][j] * scale : kNegInf;
            }
        }
        __syncthreads();

        // online softmax: each warp updates 8 rows, lanes over 64 keys
        for (int rr = 0; rr < kBQ / 8; ++rr) {
            const int r = warp * (kBQ / 8) + rr;
            float* row = Ps + r * ldp;
            const float s0 = row[lane], s1 = row[lane + 32];
            const float m_old = m_s[r];
            const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
            const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
            const float sum = warp_sum(p0 + p1);
            row[lane] = p0;
            row[lane + 32] = p1;
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                a_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();

        // acc = acc·alpha + P V
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float al = a_s[ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kNJ; ++j) acc[i][j] *= al;
        }
        for (int c = 0; c < kBK; ++c) {
            float pv[4], vv[kNJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
            for (int j = 0; j < kNJ; ++j) {
                const int d = tx + 16 * j;
                vv[j] = d < hd ? Vs[c * hd + d] : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < kNJ; ++j)
                    acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, s = q0 + r;
        if (s >= S) continue;
        const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
            const int d = tx + 16 * j;
            if (d < hd) ob[s * os.s + d] = from_f<T>(acc[i][j] / denom);
        }
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int hd, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   int causal, cudaStream_t stream) {
    const size_t smem = smem_bytes(hd);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, qs, ks, vs, os, H, KV,
        S, hd, scale, causal);
    return cudaGetLastError();
}


// ------------------------------------------------- tensor-core kernel
constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows
constexpr int kPad = 8;            // bf16 of row padding in shared memory

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) ≈ hi + lo as two packed bfloat16 pairs: hi rounds (a, b), lo
// rounds what hi leaves (exact in float32)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
}
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo)
        | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}
// d += a · b for one m16n8k16 tile (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

size_t mma_smem_bytes(int hd) {
    return sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kBK) * (hd + kPad);
}

// rows [row0, row0 + rows) of a [S, HD] bf16 slab into shared memory,
// 16 bytes a thread at a time, rows past S zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long stride, int row0, int rows,
                                          int S) {
    constexpr int kChunks = HD / 8;
    constexpr int kLd = HD + kPad;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += kMmaThreads) {
        const int r = idx / kChunks, c = idx - r * kChunks, s = row0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (s < S)
            val = *reinterpret_cast<const uint4*>(src + s * stride + c * 8);
        *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) = val;
    }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                     Strides vs, Strides os, int H, int KV, int S,
                     float scale, int causal) {
    constexpr int kLd = HD + kPad;   // conflict-free 32-bit fragment loads
    constexpr int kKSteps = HD / 16, kDTiles = HD / 8, kKeyTiles = kBK / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Ks = Qs + kBQ * kLd;
    __nv_bfloat16* Vs = Ks + kBK * kLd;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;   // mma row group, thread in it
    const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KV);
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
    __nv_bfloat16* ob = o + b * os.b + h * os.h;

    load_tile<HD>(Qs, qb, qs.s, q0, kBQ, S);
    __syncthreads();
    // A fragments of this warp's 16 query rows, all head-dim steps
    uint32_t qa[kKSteps][4];
    const __nv_bfloat16* qrow = Qs + (warp * 16 + g) * kLd + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
        qa[kk][0] = ld32(qrow + kk * 16);
        qa[kk][1] = ld32(qrow + 8 * kLd + kk * 16);
        qa[kk][2] = ld32(qrow + kk * 16 + 8);
        qa[kk][3] = ld32(qrow + 8 * kLd + kk * 16 + 8);
    }
    float acc[kDTiles][4];
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    // this thread's rows: qr0 (c0, c1) and qr0 + 8 (c2, c3)
    const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    const int kv_end = causal ? min(S, q0 + kBQ) : S;
    for (int k0 = 0; k0 < kv_end; k0 += kBK) {
        __syncthreads();   // the previous tile fully consumed
        load_tile<HD>(Ks, kb, ks.s, k0, kBK, S);
        load_tile<HD>(Vs, vb, vs.s, k0, kBK, S);
        __syncthreads();

        float sc[kKeyTiles][4];
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
            sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
            const __nv_bfloat16* krow = Ks + (j * 8 + g) * kLd + 2 * t;
#pragma unroll
            for (int kk = 0; kk < kKSteps; ++kk)
                mma_bf16(sc[j], qa[kk], ld32(krow + kk * 16),
                         ld32(krow + kk * 16 + 8));
        }
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int key = k0 + j * 8 + 2 * t + e;
                const bool ok0 = key < S && (!causal || key <= qr0);
                const bool ok1 = key < S && (!causal || key <= qr1);
                sc[j][e] = ok0 ? sc[j][e] * scale : kNegInf;
                sc[j][2 + e] = ok1 ? sc[j][2 + e] * scale : kNegInf;
                mx0 = fmaxf(mx0, sc[j][e]);
                mx1 = fmaxf(mx1, sc[j][2 + e]);
            }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                sc[j][e] = expf(sc[j][e] - mn0);
                sc[j][2 + e] = expf(sc[j][2 + e] - mn1);
                rs0 += sc[j][e];
                rs1 += sc[j][2 + e];
            }
        }
        // per-thread partial row sums; the 4 threads of a row add up at
        // the end (they share m and alpha)
        l0 = l0 * al0 + rs0;
        l1 = l1 * al1 + rs1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int n = 0; n < kDTiles; ++n) {
            acc[n][0] *= al0;
            acc[n][1] *= al0;
            acc[n][2] *= al1;
            acc[n][3] *= al1;
        }
        // O += P V: S's accumulator tiles 2kk, 2kk+1 are P's A operand,
        // its high and low bfloat16 parts one mma each
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
            uint32_t ph[4], pl[4];
            split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
            split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
            split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
            split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
            const __nv_bfloat16* vrow = Vs + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
            for (int n = 0; n < kDTiles; ++n) {
                const __nv_bfloat16* vp = vrow + n * 8;
                const uint32_t b0 = pack_raw(vp[0], vp[kLd]);
                const uint32_t b1 = pack_raw(vp[8 * kLd], vp[9 * kLd]);
                mma_bf16(acc[n], pl, b0, b1);
                mma_bf16(acc[n], ph, b0, b1);
            }
        }
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(kFull, l0, off);
        l1 += __shfl_xor_sync(kFull, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
        const int d = n * 8 + 2 * t;
        if (qr0 < S)
            *reinterpret_cast<uint32_t*>(ob + qr0 * os.s + d) =
                pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
        if (qr1 < S)
            *reinterpret_cast<uint32_t*>(ob + qr1 * os.s + d) =
                pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
    }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* o, int B, int H, int KV, int S, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale,
                       int causal, cudaStream_t stream) {
    const size_t smem = mma_smem_bytes(HD);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    flash_fwd_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, qs, ks, vs, os, H, KV,
        S, scale, causal);
    return cudaGetLastError();
}

bool rows_aligned(const void* p, Strides st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0
        && st.h % 8 == 0 && st.s % 8 == 0;
}

}  // namespace

extern "C" {

// q [B, H, S, hd], k and v [B, KV, S, hd], o [B, H, S, hd], each given
// by its element strides of (batch, head, sequence) with the head dim
// contiguous.  bf16 != 0: all four are bfloat16, else float32.  hd <=
// 128, H a multiple of KV.  bfloat16 with hd 64 or 128, 16-byte aligned
// pointers and strides that are multiples of 8 go to the tensor-core
// kernel, everything else to the CUDA-core one.  Returns
// cudaGetLastError() of the launch.
int flash_attention_launch(int bf16, const void* q, const void* k,
                           const void* v, void* o, int B, int H, int KV,
                           int S, int hd, long qsb, long qsh, long qss,
                           long ksb, long ksh, long kss, long vsb, long vsh,
                           long vss, long osb, long osh, long oss,
                           float scale, int causal, void* stream) {
    if (B == 0 || H == 0 || S == 0) return 0;
    if (hd > kMaxHd || KV == 0 || H % KV != 0)
        return (int)cudaErrorInvalidValue;
    const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
        os{osb, osh, oss};
    if (bf16 && (hd == 64 || hd == 128) && rows_aligned(q, qs)
            && rows_aligned(k, ks) && rows_aligned(v, vs)
            && rows_aligned(o, os)) {
        if (hd == 64)
            return (int)launch_mma<64>(q, k, v, o, B, H, KV, S, qs, ks, vs,
                                       os, scale, causal,
                                       (cudaStream_t)stream);
        return (int)launch_mma<128>(q, k, v, o, B, H, KV, S, qs, ks, vs, os,
                                    scale, causal, (cudaStream_t)stream);
    }
    if (bf16)
        return (int)launch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, hd, qs,
                                          ks, vs, os, scale, causal,
                                          (cudaStream_t)stream);
    return (int)launch<float>(q, k, v, o, B, H, KV, S, hd, qs, ks, vs, os,
                              scale, causal, (cudaStream_t)stream);
}

}  // extern "C"
