// Grouped-query attention, backward: dq, dk and dv of K4's forward
// (flash_attention.cu), for training.
//
// The JAX package has no backward kernel: it differentiates plain
// attention (src/repro/models/layers/attention.py), so this kernel's
// plain version is the gradient of kernels/ref.py:flash_attention_ref
// under autograd.  It takes exactly the cases the forward takes: causal
// (Sk = Sq) or not (any Sk: the encoder-decoder's cross attention),
// grouped-query heads (KV head of query head h: h / (H / KV)), packed
// segment ids [B, Sq] (Sk = Sq; a key of another segment than its
// query's is masked), float32 or bfloat16 inputs.  Every sum is
// float32; dq, dk and dv are written once each in the input's type.
//
// FlashAttention-2's layout in three launches, no atomics (a call
// repeats bit for bit):
//
// 1. D = rowsum(dO ∘ O) [B, H, Sq] float32, one warp a row, from the
//    forward's float32 output (for bfloat16 its `o32`, the output before
//    the cast: what the float32 plain version's autograd sums).
// 2. dK and dV: one CTA a (64-key block, KV head, batch row).  It keeps
//    its K and V tiles in shared memory and walks the query blocks of
//    every query head of its group (the GQA sum stays in the CTA; when
//    causal only the blocks at or below the diagonal), recomputing
//    P = exp2(S·scale·log2 e − lse·log2 e) from the forward's
//    log-sum-exp (natural-log units, converted once a row: the forward's
//    exponent base and scale, so P is the forward's up to rounding), then
//    dP = dO Vᵀ and dS = P ∘ (dP − D) in float32, and accumulating
//    dV += Pᵀ dO and dK += dSᵀ Q (times the scale at the end) in
//    registers.
// 3. dQ: one CTA a (64-query block, head, batch row), the longest
//    (causal: the last) blocks first, walking the key blocks (causal: up
//    to the diagonal) with the same recomputation, dQ += dS K · scale.
//
// CUDA cores: 256 threads, thread (ty, tx) of a 16 x 16 grid owns the
// score entries (rows ty + 16i, columns tx + 16j) and output rows ty +
// 16i, dims tx + 16j (j < NJ = hd / 16 rounded up, NJ 4 or 8); tiles are
// float32 in shared memory, rows padded to hd + 1 so that the column
// reads of both products are conflict-free.  Masked entries (keys past
// Sk, queries past Sq, future keys when causal, other segments) have
// P = dS = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // queries and keys per block
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

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

struct Strides {   // element strides of the batch, head and sequence axes
    long b, h, s;
};

// ---------------------------------------------------- 1. D = rowsum(dO∘O)
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Strides os, Strides dos, int H,
                 int Sq, int hd) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * (kThreads / 32) + warp;
    const int h = blockIdx.y, b = blockIdx.z;
    if (r >= Sq) return;
    const float* orow = o + b * os.b + h * os.h + r * os.s;
    const T* drow = dout + b * dos.b + h * dos.h + r * dos.s;
    float acc = 0.0f;
    for (int d = lane; d < hd; d += 32)
        acc = fmaf(orow[d], to_f(drow[d]), acc);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) delta[((long)b * H + h) * Sq + r] = acc;
}

// a [64][hd] tile of rows [row0, row0 + 64) of a strided slab into
// shared memory as float32 rows of `ld`, rows past S zero-filled
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long stride, int row0, int S,
                                          int hd) {
    for (int idx = threadIdx.x; idx < kB * hd; idx += kThreads) {
        const int r = idx / hd, d = idx - r * hd, s = row0 + r;
        dst[r * ld + d] = s < S ? to_f(src[s * stride + d]) : 0.0f;
    }
}

// the score block's S = A Bᵀ and dP = C Dᵀ entries of this thread (rows
// ty + 16i of A and C, rows tx + 16j of B and D), over hd
__device__ __forceinline__ void two_products(
        float (&s)[4][4], float (&p)[4][4], const float* A, const float* Bm,
        const float* C, const float* D, int ld, int hd, int ty, int tx) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = p[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
        float a[4], bb[4], c[4], dd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            a[i] = A[(ty + 16 * i) * ld + d];
            c[i] = C[(ty + 16 * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            bb[j] = Bm[(tx + 16 * j) * ld + d];
            dd[j] = D[(tx + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = fmaf(a[i], bb[j], s[i][j]);
                p[i][j] = fmaf(c[i], dd[j], p[i][j]);
            }
    }
}

// shared memory: four [64][hd + 1] tiles, two [64][65] score tiles (the
// dQ kernel uses one), and four [64] row / column vectors
size_t smem_bytes(int hd) {
    return sizeof(float) * (4 * (size_t)kB * (hd + 1)
                            + 2 * (size_t)kB * (kB + 1) + 4 * kB);
}

// ------------------------------------------------------ 2. dK and dV
template <typename T, bool SEG, int NJ>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ seg,
                T* __restrict__ dk, T* __restrict__ dv, Strides qs,
                Strides ks, Strides vs, Strides dos, Strides dks,
                Strides dvs, int H, int KV, int Sq, int Sk, int hd,
                float scale, int causal) {
    extern __shared__ float smem[];
    const int ld = hd + 1, ldp = kB + 1;
    float* Ks = smem;
    float* Vs = Ks + kB * ld;
    float* Qs = Vs + kB * ld;
    float* dOs = Qs + kB * ld;
    float* Ps = dOs + kB * ld;
    float* dSs = Ps + kB * ldp;
    float* lse_s = dSs + kB * ldp;         // this block's rows, log2 units
    float* D_s = lse_s + kB;
    int* segq_s = reinterpret_cast<int*>(D_s + kB);
    int* segk_s = segq_s + kB;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int k0 = blockIdx.x * kB, kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / KV;
    const float scale2 = scale * kLog2e;

    load_tile(Ks, ld, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk, hd);
    load_tile(Vs, ld, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk, hd);
    if (SEG && tid < kB)
        segk_s[tid] = k0 + tid < Sk ? seg[(long)b * Sq + k0 + tid] : -2;

    float adk[4][NJ], adv[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.0f;

    const int nqb = (Sq + kB - 1) / kB;
    const int qb0 = causal ? k0 / kB : 0;
    for (int hh = 0; hh < G; ++hh) {
        const int h = kvh * G + hh;
        const T* qh = q + b * qs.b + h * qs.h;
        const T* doh = dout + b * dos.b + h * dos.h;
        const float* lse_h = lse + ((long)b * H + h) * Sq;
        const float* D_h = delta + ((long)b * H + h) * Sq;
        for (int qb = qb0; qb < nqb; ++qb) {
            const int q0 = qb * kB;
            __syncthreads();   // the previous block's tiles consumed
            load_tile(Qs, ld, qh, qs.s, q0, Sq, hd);
            load_tile(dOs, ld, doh, dos.s, q0, Sq, hd);
            if (tid < kB) {
                const bool in = q0 + tid < Sq;
                lse_s[tid] = in ? lse_h[q0 + tid] * kLog2e : 0.0f;
                D_s[tid] = in ? D_h[q0 + tid] : 0.0f;
                if (SEG) segq_s[tid] = in ? seg[(long)b * Sq + q0 + tid] : -1;
            }
            __syncthreads();

            float s[4][4], dp[4][4];
            two_products(s, dp, Qs, Ks, dOs, Vs, ld, hd, ty, tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty + 16 * i, qr = q0 + r;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = tx + 16 * j, kc = k0 + c;
                    const bool ok = qr < Sq && kc < Sk
                        && (!causal || kc <= qr)
                        && (!SEG || segq_s[r] == segk_s[c]);
                    const float p = ok ? exp2f(s[i][j] * scale2 - lse_s[r])
                                       : 0.0f;
                    Ps[r * ldp + c] = p;
                    dSs[r * ldp + c] = p * (dp[i][j] - D_s[r]);
                }
            }
            __syncthreads();

            // dV[c] += Σ_r P[r, c] dO[r];  dK[c] += Σ_r dS[r, c] Q[r]
            for (int r = 0; r < kB; ++r) {
                float pv[4], sv[4], ov[NJ], qv[NJ];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    pv[i] = Ps[r * ldp + ty + 16 * i];
                    sv[i] = dSs[r * ldp + ty + 16 * i];
                }
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const int d = tx + 16 * j;
                    ov[j] = d < hd ? dOs[r * ld + d] : 0.0f;
                    qv[j] = d < hd ? Qs[r * ld + d] : 0.0f;
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < NJ; ++j) {
                        adv[i][j] = fmaf(pv[i], ov[j], adv[i][j]);
                        adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);
                    }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kc = k0 + ty + 16 * i;
        if (kc >= Sk) continue;
        T* dkr = dk + b * dks.b + kvh * dks.h + kc * dks.s;
        T* dvr = dv + b * dvs.b + kvh * dvs.h + kc * dvs.s;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < hd) {
                dkr[d] = from_f<T>(adk[i][j] * scale);
                dvr[d] = from_f<T>(adv[i][j]);
            }
        }
    }
}

// ------------------------------------------------------------- 3. dQ
template <typename T, bool SEG, int NJ>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ seg, T* __restrict__ dq, Strides qs,
              Strides ks, Strides vs, Strides dos, Strides dqs, int H,
              int KV, int Sq, int Sk, int hd, float scale, int causal) {
    extern __shared__ float smem[];
    const int ld = hd + 1, ldp = kB + 1;
    float* Qs = smem;
    float* dOs = Qs + kB * ld;
    float* Ks = dOs + kB * ld;
    float* Vs = Ks + kB * ld;
    float* dSs = Vs + kB * ld;
    float* lse_s = dSs + 2 * kB * ldp;
    float* D_s = lse_s + kB;
    int* segq_s = reinterpret_cast<int*>(D_s + kB);
    int* segk_s = segq_s + kB;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    // the longest blocks first: causal, block i walks i + 1 key blocks
    const int nqb = (Sq + kB - 1) / kB, qb = nqb - 1 - (int)blockIdx.x;
    const int q0 = qb * kB, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KV);
    const float scale2 = scale * kLog2e;

    load_tile(Qs, ld, q + b * qs.b + h * qs.h, qs.s, q0, Sq, hd);
    load_tile(dOs, ld, dout + b * dos.b + h * dos.h, dos.s, q0, Sq, hd);
    if (tid < kB) {
        const bool in = q0 + tid < Sq;
        const long row = ((long)b * H + h) * Sq + q0 + tid;
        lse_s[tid] = in ? lse[row] * kLog2e : 0.0f;
        D_s[tid] = in ? delta[row] : 0.0f;
        if (SEG) segq_s[tid] = in ? seg[(long)b * Sq + q0 + tid] : -1;
    }
    const T* kh = k + b * ks.b + kvh * ks.h;
    const T* vh = v + b * vs.b + kvh * vs.h;

    float adq[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) adq[i][j] = 0.0f;

    const int nkb = causal ? qb + 1 : (Sk + kB - 1) / kB;
    for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * kB;
        __syncthreads();   // Q staged; the previous key block consumed
        load_tile(Ks, ld, kh, ks.s, k0, Sk, hd);
        load_tile(Vs, ld, vh, vs.s, k0, Sk, hd);
        if (SEG && tid < kB)
            segk_s[tid] = k0 + tid < Sk ? seg[(long)b * Sq + k0 + tid] : -2;
        __syncthreads();

        float s[4][4], dp[4][4];
        two_products(s, dp, Qs, Ks, dOs, Vs, ld, hd, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i, qr = q0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j, kc = k0 + c;
                const bool ok = qr < Sq && kc < Sk && (!causal || kc <= qr)
                    && (!SEG || segq_s[r] == segk_s[c]);
                const float p = ok ? exp2f(s[i][j] * scale2 - lse_s[r])
                                   : 0.0f;
                dSs[r * ldp + c] = p * (dp[i][j] - D_s[r]);
            }
        }
        __syncthreads();

        // dQ[r] += Σ_c dS[r, c] K[c]
        for (int c = 0; c < kB; ++c) {
            float sv[4], kv[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * ldp + c];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int d = tx + 16 * j;
                kv[j] = d < hd ? Ks[c * ld + d] : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    adq[i][j] = fmaf(sv[i], kv[j], adq[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty + 16 * i;
        if (qr >= Sq) continue;
        T* dqr = dq + b * dqs.b + h * dqs.h + qr * dqs.s;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < hd) dqr[d] = from_f<T>(adq[i][j] * scale);
        }
    }
}

struct Args {
    const void *q, *k, *v, *dout;
    const float *o, *lse;
    const int* seg;
    void *dq, *dk, *dv;
    float* delta;
    int B, H, KV, Sq, Sk, hd;
    Strides qs, ks, vs, os, dos, dqs, dks, dvs;
    float scale;
    int causal;
};

template <typename T, bool SEG, int NJ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    const size_t smem = smem_bytes(a.hd);
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_kernel<T, SEG, NJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq_kernel<T, SEG, NJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const int rows = kThreads / 32;
    const dim3 dgrid((a.Sq + rows - 1) / rows, a.H, a.B);
    bwd_delta_kernel<T><<<dgrid, kThreads, 0, stream>>>(
        a.o, (const T*)a.dout, a.delta, a.os, a.dos, a.H, a.Sq, a.hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dkdv_kernel<T, SEG, NJ><<<dim3((a.Sk + kB - 1) / kB, a.KV, a.B),
                                  kThreads, smem, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        a.lse, a.delta, a.seg, (T*)a.dk, (T*)a.dv, a.qs, a.ks, a.vs, a.dos,
        a.dks, a.dvs, a.H, a.KV, a.Sq, a.Sk, a.hd, a.scale, a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dq_kernel<T, SEG, NJ><<<dim3((a.Sq + kB - 1) / kB, a.H, a.B),
                                kThreads, smem, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        a.lse, a.delta, a.seg, (T*)a.dq, a.qs, a.ks, a.vs, a.dos, a.dqs,
        a.H, a.KV, a.Sq, a.Sk, a.hd, a.scale, a.causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
    const bool seg = a.seg != nullptr;
    if (a.hd <= 64)
        return seg ? launch<T, true, 4>(a, stream)
                   : launch<T, false, 4>(a, stream);
    return seg ? launch<T, true, 8>(a, stream)
               : launch<T, false, 8>(a, stream);
}

}  // namespace

extern "C" {

// The gradient of flash_attention_fwd_launch's output o: q, o, dout, dq
// [B, H, Sq, hd], k, v, dk, dv [B, KV, Sk, hd], each given by its element
// strides of (batch, head, sequence) with the head dim contiguous; lse
// [B, H, Sq] float32 contiguous (the forward's, natural log); seg null or
// [B, Sq] int32 contiguous; delta [B, H, Sq] float32 scratch.  bf16 != 0:
// q, k, v, dout, dq, dk, dv are bfloat16, else float32; o is float32
// either way (a bfloat16 forward's o32: D from the rounded output would
// be off by its rounding).  hd <=
// 128, H a multiple of KV, Sk >= 1, Sk = Sq when causal or segmented.
// Three launches on `stream`; returns the first error.
int flash_attention_bwd_launch(
        int bf16, const void* q, const void* k, const void* v,
        const float* o,
        const void* dout, const float* lse, const int* seg, void* dq,
        void* dk, void* dv, float* delta, int B, int H, int KV, int Sq,
        int Sk, int hd, long qsb, long qsh, long qss, long ksb, long ksh,
        long kss, long vsb, long vsh, long vss, long osb, long osh,
        long oss, long dosb, long dosh, long doss, long dqsb, long dqsh,
        long dqss, long dksb, long dksh, long dkss, long dvsb, long dvsh,
        long dvss, float scale, int causal, void* stream) {
    if (B == 0 || H == 0 || Sq == 0) return 0;
    if (hd < 1 || hd > kMaxHd || KV == 0 || H % KV != 0 || Sk < 1
            || ((causal || seg != nullptr) && Sk != Sq))
        return (int)cudaErrorInvalidValue;
    Args a{q, k, v, dout, o, lse, seg, dq, dk, dv, delta, B, H, KV, Sq, Sk,
           hd, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
           {osb, osh, oss}, {dosb, dosh, doss}, {dqsb, dqsh, dqss},
           {dksb, dksh, dkss}, {dvsb, dvsh, dvss}, scale, causal};
    if (bf16) return (int)dispatch<__nv_bfloat16>(a, (cudaStream_t)stream);
    return (int)dispatch<float>(a, (cudaStream_t)stream);
}

}  // extern "C"
