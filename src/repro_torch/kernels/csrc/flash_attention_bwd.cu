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
// Bound, at Qwen3-0.6B's training shape (q [8, 16, 512, 128] against
// 8 KV heads, bfloat16, causal, packed): the bytes read and written
// (q, k, v, o, dO, dq, dk, dv, lse) at 3.35 TB/s, which take longer
// than the five products of the kept pairs at 989 TFLOP/s
// (chip_smoke.py's bound_ms).  Each CTA walks its blocks one after
// another, so latency and the card's fill set the pace.
//
// Two designs of launches 2 and 3, picked by what the launch can
// observe:
//
// * bfloat16 with hd 64 or 128 and 16-byte aligned rows (the forward's
//   test): Hopper tensor cores, one warpgroup (128 threads, 64 rows) a
//   CTA, every product wgmma m64n64k16.  In the dK/dV kernel the key
//   block is the M side: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ over the whole head
//   dim with K and V resident in shared memory and Q, dO streamed;
//   Pᵀ and dSᵀ stay in the accumulator layout, which is the A-fragment
//   layout (as the forward's P V), so dV += Pᵀ dO and dK += dSᵀ Q take
//   them from registers with dO and Q as MN-major B operands.  A CTA
//   owns 64 columns of dK and dV: at hd 128 two CTAs share a key block
//   and each computes its scores, which keeps a thread at 64
//   accumulator floats beside the 64 of Sᵀ and dPᵀ and the parts
//   (~240 registers), two CTAs an SM, and doubles the grid.  The dQ
//   kernel recomputes S = Q Kᵀ and dP = dO Vᵀ the same way (Q and dO
//   resident, K and V streamed) and runs dQ += dS K over every column.
//   Tiles arrive by cp.async in the 128-byte swizzle through a ring (2
//   stages at hd 128: 96 KB a CTA; 3 at hd 64), rows past the slab
//   zero-filled, and the streamed rows' log-sum-exp, D and segment ids
//   travel beside them.  The plain version computes in float32 and
//   casts once, so P and dS (float32) enter the bf16 products as three
//   bfloat16 parts each (split_bf16_3, float32's 2^-25, as the
//   forward's training path), three wgmma into the same float32
//   accumulator; Q, K, V and dO are bfloat16 and exact.  That makes
//   the tensor work ~2.2x the five plain products' operations.
// * float32, or any other head dim: CUDA cores.  256 threads, thread
//   (ty, tx) of a 16 x 16 grid owns the score entries (rows ty + 16i,
//   columns tx + 16j) and output rows ty + 16i, dims tx + 16j (j < NJ =
//   hd / 16 rounded up, NJ 4 or 8); tiles are float32 in shared memory,
//   rows padded to hd + 1 so that the column reads of both products are
//   conflict-free.
//
// Masked entries (keys past Sk, queries past Sq, future keys when
// causal, other segments) have P = dS = 0 in both.

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

// ------------------------------------------- tensor-core kernels (Hopper)
// The helpers below are the forward's (flash_attention.cu), copied so
// that each source stays self-contained.
constexpr int kWgThreads = 128;    // one warpgroup a CTA
constexpr uint32_t kBlockBytes = 64 * 128;   // 64 rows of 128 bytes
constexpr int kParts = 3;          // bfloat16 parts of P and dS

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) ≈ hi + mid + lo as three packed bfloat16 pairs, each rounding
// what the earlier parts leave: a relative 2^-25, float32's
__device__ __forceinline__ void split_bf16_3(float a, float b, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const float ra = a - hf.x, rb = b - hf.y;
    __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
    const float2 mf = __bfloat1622float2(m);
    __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    mid = *reinterpret_cast<uint32_t*>(&m);
    lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// this thread's shared-memory writes, visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// pins the accumulator registers in program order around wgmma, which
// reads and writes them asynchronously
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
// K-major: 8-row groups 1024 bytes apart (stride), the leading offset
// unused.  MN-major: 64-column blocks `lbo` apart (leading), 8-row
// groups 1024 bytes apart (stride).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
        | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d[0..31] (+)= A·B for one m64n64k16 step, A and B from shared memory
// (K-major, 128-byte swizzle); scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..31] += A·B for one m64n64k16 step: A from registers (the
// m16n8k16 A-fragment layout per warp), B from shared memory
// (MN-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A tile of 64 rows [row0, row0 + 64) of a [S, HD] bf16 slab into
// shared memory at `dst` (1024-byte aligned) by cp.async, 16 bytes a
// thread at a time over the warpgroup, rows past S zero-filled.  Layout:
// HD / 64 blocks of 64 rows x 128 bytes, 16-byte chunk c of row r at
// chunk c ^ (r % 8) (the 128-byte swizzle wgmma reads), so both the
// K-major and the MN-major descriptors address it.
template <int HD>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long stride, int row0,
                                                int S) {
    constexpr int kChunks = HD / 8;
#pragma unroll
    for (int i = 0; i < 64 * kChunks / kWgThreads; ++i) {
        const int idx = threadIdx.x + i * kWgThreads;
        const int r = idx / kChunks, c = idx % kChunks, s = row0 + r;
        const bool ok = s < S;
        const uint32_t off = (c / 8) * kBlockBytes + r * 128
            + (((c % 8) ^ (r % 8)) << 4);
        cp_async16(dst + off, src + (long)(ok ? s : 0) * stride + c * 8, ok);
    }
}

// d = A Bᵀ over the head dim for two 64-row tiles at `sa` and `sb`,
// both K-major: HD / 16 steps of m64n64k16
template <int HD>
__device__ __forceinline__ void product_over_hd(float (&d)[32], uint32_t sa,
                                                uint32_t sb) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
        wgmma_ss_n64(d, sw128_desc(sa + off, 16, 1024),
                     sw128_desc(sb + off, 16, 1024), kk > 0);
    }
}

// d += A B over 64 rows of B, A a 64 x 64 float32 accumulator `x`:
// split_parts cuts x into kParts bfloat16 parts (its entries 8kk..8kk+7
// are the A fragment of step kk), product_parts runs each part as one
// wgmma into the same float32 accumulator, smallest first, with B the
// 64-column block at `sb` of a 64-row tile, MN-major (16 rows = 2048
// bytes a step)
__device__ __forceinline__ void split_parts(const float (&x)[32],
                                            uint32_t (&pp)[kParts][4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
            split_bf16_3(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1],
                         pp[0][kk][i], pp[1][kk][i], pp[2][kk][i]);
}
__device__ __forceinline__ void product_parts(
        float (&d)[32], const uint32_t (&pp)[kParts][4][4], uint32_t sb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(sb + kk * 2048, kBlockBytes, 1024);
#pragma unroll
        for (int part = kParts - 1; part >= 0; --part)
            wgmma_rs_n64(d, pp[part][kk], db);
    }
}

// streamed tile pairs in a CTA's ring: 2 at hd 128, so that two CTAs
// (96 KB each) share an SM, 3 at hd 64
__host__ __device__ constexpr int ring_stages(int hd) {
    return hd == 128 ? 2 : 3;
}

// shared memory of one tensor-core CTA: 2 resident tiles, the ring's
// pairs of streamed tiles, then 3 x 64 words of per-row values a stage
size_t wgmma_smem_bytes(int hd) {
    const int st = ring_stages(hd);
    return (size_t)(2 + 2 * st) * 64 * hd * 2 + (size_t)st * 3 * 64 * 4
        + 1024;
}

// dK and dV on the tensor cores: one CTA of one warpgroup per (KV head,
// batch row, 64-key block, 64-column block w of dK and dV).  K and V
// stay in shared memory; the (head of the group, 64-query block) pairs
// stream Q, dO and the rows' log-sum-exp (log2 units), D and segment
// ids through a ring.  The CTA computes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ over
// the whole head dim (keys on the M side: the accumulator rows are this
// thread's keys, the columns the block's queries), Pᵀ = exp2(Sᵀ·scale·
// log2 e − lse·log2 e) and dSᵀ = Pᵀ ∘ (dPᵀ − D) in registers, and then
// dV += Pᵀ dO and dK += dSᵀ Q with Pᵀ and dSᵀ as register A operands
// (kParts parts each) and column block w of dO and Q as MN-major B
// operands.
// At hd 128 the two column blocks' CTAs compute the same scores: that
// keeps a thread's accumulators at 64 floats (its halves of dK and dV)
// beside the 64 of Sᵀ and dPᵀ and the parts, two CTAs an SM.
template <int HD, bool SEG>
__global__ void __launch_bounds__(kWgThreads, 2)
bwd_dkdv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, Strides qs, Strides ks,
                      Strides vs, Strides dos, Strides dks, Strides dvs,
                      int H, int KV, int Sq, int Sk, float scale,
                      int causal) {
    constexpr int ST = ring_stages(HD), NW = HD / 64;
    constexpr uint32_t kTile = 64 * HD * 2;    // bytes of one 64-row tile
    extern __shared__ unsigned char smem_raw[];
    const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sV = sK + kTile;
    // stage s: Q at sK + kTile·(2 + 2s), dO right after it
    float* stats = reinterpret_cast<float*>(
        smem_raw + (sK - smem_u32(smem_raw)) + (2 + 2 * ST) * kTile);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // the longest blocks first: causal, key block kb meets nqb - kb
    // query blocks of each head, and blockIdx.z = 0 is scheduled first
    const int kvh = blockIdx.x, b = blockIdx.y;
    const int kb = blockIdx.z / NW, wg = blockIdx.z % NW;
    const int k0 = kb * 64, G = H / KV;
    const int nqb = (Sq + 63) / 64, qb0 = causal ? kb : 0;
    const int n_per = nqb - qb0, n_it = G * n_per;
    const float scale2 = scale * kLog2e;
    const int* segb = SEG ? seg + (long)b * Sq : nullptr;

    auto load_stage = [&](int it) {
        const int st = it % ST, h = kvh * G + it / n_per;
        const int q0 = (qb0 + it % n_per) * 64;
        const uint32_t sQ = sK + kTile * (2 + 2 * st);
        load_tile_async<HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
        load_tile_async<HD>(sQ + kTile, dout + b * dos.b + h * dos.h,
                                dos.s, q0, Sq);
        if (threadIdx.x < 64) {
            const int r = q0 + threadIdx.x;
            const bool in = r < Sq;
            const long row = ((long)b * H + h) * Sq + r;
            float* sv = stats + st * 192;
            sv[threadIdx.x] = in ? lse[row] * kLog2e : 0.0f;
            sv[64 + threadIdx.x] = in ? delta[row] : 0.0f;
            if (SEG)
                reinterpret_cast<int*>(sv)[128 + threadIdx.x] =
                    in ? segb[r] : -1;
        }
    };
    // the ring: group 0 carries K, V and stage 0, group j stage j; one
    // group is committed per step (empty past the last) so that
    // wait_group<ST - 2> always means "stage it has landed"
    load_tile_async<HD>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk);
    load_tile_async<HD>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk);
#pragma unroll
    for (int j = 0; j < ST - 1; ++j) {
        if (j < n_it) load_stage(j);
        cp_async_commit();
    }

    float adk[32], adv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) adk[i] = adv[i] = 0.0f;
    // this thread's keys: kr0 (accumulator entries 0, 1) and kr0 + 8
    const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
    const int sk0 = SEG && kr0 < Sk ? segb[kr0] : -2;
    const int sk1 = SEG && kr1 < Sk ? segb[kr1] : -2;

    for (int it = 0; it < n_it; ++it) {
        cp_async_wait<ST - 2>();
        fence_proxy_async();
        __syncthreads();   // stage it landed; stage it - 1 fully consumed
        if (it + ST - 1 < n_it) load_stage(it + ST - 1);
        cp_async_commit();
        const int st = it % ST;
        const uint32_t sQ = sK + kTile * (2 + 2 * st), sdO = sQ + kTile;
        const float* lse_s = stats + st * 192;
        const float* D_s = lse_s + 64;
        const int* sq_s = reinterpret_cast<const int*>(lse_s + 128);
        const int qb = qb0 + it % n_per, q0 = qb * 64;

        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
        wgmma_fence();
        product_over_hd<HD>(sc, sK, sQ);       // Sᵀ = K Qᵀ
        product_over_hd<HD>(dp, sV, sdO);      // dPᵀ = V dOᵀ
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // sc[4j + e]: key kr0 (e < 2) or kr1, query q0 + 8j + 2t + (e & 1)
        const bool masked = SEG || (causal && qb == kb) || k0 + 64 > Sk
            || q0 + 64 > Sq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
            const float2 dd = *reinterpret_cast<const float2*>(D_s + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int ce = c + (e & 1), qc = q0 + ce;
                const int kr = e < 2 ? kr0 : kr1;
                float p = exp2f(sc[4 * j + e] * scale2
                                - ((e & 1) ? l2.y : l2.x));
                if (masked) {
                    const bool ok = kr < Sk && qc < Sq
                        && (!causal || kr <= qc)
                        && (!SEG || (e < 2 ? sk0 : sk1) == sq_s[ce]);
                    p = ok ? p : 0.0f;
                }
                sc[4 * j + e] = p;
                const float de = (e & 1) ? dd.y : dd.x;
                dp[4 * j + e] = p * (dp[4 * j + e] - de);
            }
        }
        // dV += Pᵀ dO and dK += dSᵀ Q on this CTA's column block
        uint32_t pp[kParts][4][4], ps[kParts][4][4];
        split_parts(sc, pp);
        split_parts(dp, ps);
        wgmma_fence();
        product_parts(adv, pp, sdO + wg * kBlockBytes);
        product_parts(adk, ps, sQ + wg * kBlockBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(adv);
        fence_regs(adk);
    }

    __nv_bfloat16* dkb = dk + b * dks.b + kvh * dks.h;
    __nv_bfloat16* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        const int d = wg * 64 + n * 8 + 2 * t;
        if (kr0 < Sk) {
            *reinterpret_cast<uint32_t*>(dkb + kr0 * dks.s + d) =
                pack_bf16(adk[4 * n] * scale, adk[4 * n + 1] * scale);
            *reinterpret_cast<uint32_t*>(dvb + kr0 * dvs.s + d) =
                pack_bf16(adv[4 * n], adv[4 * n + 1]);
        }
        if (kr1 < Sk) {
            *reinterpret_cast<uint32_t*>(dkb + kr1 * dks.s + d) =
                pack_bf16(adk[4 * n + 2] * scale, adk[4 * n + 3] * scale);
            *reinterpret_cast<uint32_t*>(dvb + kr1 * dvs.s + d) =
                pack_bf16(adv[4 * n + 2], adv[4 * n + 3]);
        }
    }
}

// dQ on the tensor cores: one CTA of one warpgroup per (head, batch row,
// 64-query block), the longest (causal: the last) blocks first.  Q, dO
// and the rows' log-sum-exp and D stay; the key blocks (causal: up to
// the diagonal) stream K, V and the keys' segment ids through a ring.
// S = Q Kᵀ and dP = dO Vᵀ over the whole head dim, P and dS = P ∘ (dP −
// D) in registers, dQ += dS K with dS a register A operand (kParts
// parts) and each 64-column block of K an MN-major B operand.
template <int HD, bool SEG>
__global__ void __launch_bounds__(kWgThreads, 2)
bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ dq, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, int H, int KV,
                    int Sq, int Sk, float scale, int causal) {
    constexpr int ST = ring_stages(HD), NW = HD / 64;
    constexpr uint32_t kTile = 64 * HD * 2;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sdO = sQ + kTile;
    // stage s: K at sQ + kTile·(2 + 2s), V right after it
    int* segk_all = reinterpret_cast<int*>(
        smem_raw + (sQ - smem_u32(smem_raw)) + (2 + 2 * ST) * kTile);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nqb = (Sq + 63) / 64, qb = nqb - 1 - (int)blockIdx.z;
    const int h = blockIdx.x, b = blockIdx.y, q0 = qb * 64;
    const int kvh = h / (H / KV);
    const int n_kt = causal ? qb + 1 : (Sk + 63) / 64;
    const float scale2 = scale * kLog2e;
    const int* segb = SEG ? seg + (long)b * Sq : nullptr;
    const __nv_bfloat16* kh = k + b * ks.b + kvh * ks.h;
    const __nv_bfloat16* vh = v + b * vs.b + kvh * vs.h;

    auto load_stage = [&](int kt) {
        const int st = kt % ST;
        const uint32_t sKs = sQ + kTile * (2 + 2 * st);
        load_tile_async<HD>(sKs, kh, ks.s, kt * 64, Sk);
        load_tile_async<HD>(sKs + kTile, vh, vs.s, kt * 64, Sk);
        if (SEG && threadIdx.x < 64) {
            const int key = kt * 64 + threadIdx.x;
            segk_all[st * 64 + threadIdx.x] = key < Sk ? segb[key] : -2;
        }
    };
    load_tile_async<HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
    load_tile_async<HD>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0,
                            Sq);
#pragma unroll
    for (int j = 0; j < ST - 1; ++j) {
        if (j < n_kt) load_stage(j);
        cp_async_commit();
    }

    float adq[NW][32];
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) adq[n][i] = 0.0f;
    // this thread's rows: qr0 (accumulator entries 0, 1) and qr0 + 8
    const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;
    const long row0 = ((long)b * H + h) * Sq;
    const float lse0 = qr0 < Sq ? lse[row0 + qr0] * kLog2e : 0.0f;
    const float lse1 = qr1 < Sq ? lse[row0 + qr1] * kLog2e : 0.0f;
    const float D0 = qr0 < Sq ? delta[row0 + qr0] : 0.0f;
    const float D1 = qr1 < Sq ? delta[row0 + qr1] : 0.0f;
    const int sq0 = SEG && qr0 < Sq ? segb[qr0] : -1;
    const int sq1 = SEG && qr1 < Sq ? segb[qr1] : -1;

    for (int kt = 0; kt < n_kt; ++kt) {
        cp_async_wait<ST - 2>();
        fence_proxy_async();
        __syncthreads();   // stage kt landed; stage kt - 1 fully consumed
        if (kt + ST - 1 < n_kt) load_stage(kt + ST - 1);
        cp_async_commit();
        const int st = kt % ST;
        const uint32_t sK = sQ + kTile * (2 + 2 * st), sV = sK + kTile;
        const int* sk_s = segk_all + st * 64;
        const int k0 = kt * 64;

        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
        wgmma_fence();
        product_over_hd<HD>(sc, sQ, sK);       // S = Q Kᵀ
        product_over_hd<HD>(dp, sdO, sV);      // dP = dO Vᵀ
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // sc[4j + e]: row qr0 (e < 2) or qr1, key k0 + 8j + 2t + (e & 1)
        const bool masked = SEG || (causal && kt == qb) || k0 + 64 > Sk
            || q0 + 64 > Sq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int ce = 8 * j + 2 * t + (e & 1), key = k0 + ce;
                const int qr = e < 2 ? qr0 : qr1;
                float p = exp2f(sc[4 * j + e] * scale2
                                - (e < 2 ? lse0 : lse1));
                if (masked) {
                    const bool ok = key < Sk && qr < Sq
                        && (!causal || key <= qr)
                        && (!SEG || (e < 2 ? sq0 : sq1) == sk_s[ce]);
                    p = ok ? p : 0.0f;
                }
                dp[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? D0 : D1));
            }
        }
        uint32_t ps[kParts][4][4];
        split_parts(dp, ps);
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < NW; ++n)                      // dQ += dS K
            product_parts(adq[n], ps, sK + n * kBlockBytes);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int n = 0; n < NW; ++n) fence_regs(adq[n]);
    }

    __nv_bfloat16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int c = 0; c < NW * 8; ++c) {
        const float* a = adq[c / 8] + 4 * (c % 8);
        const int d = c * 8 + 2 * t;
        if (qr0 < Sq)
            *reinterpret_cast<uint32_t*>(dqb + qr0 * dqs.s + d) =
                pack_bf16(a[0] * scale, a[1] * scale);
        if (qr1 < Sq)
            *reinterpret_cast<uint32_t*>(dqb + qr1 * dqs.s + d) =
                pack_bf16(a[2] * scale, a[3] * scale);
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

template <int HD, bool SEG>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
    const size_t smem = wgmma_smem_bytes(HD);
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_wgmma_kernel<HD, SEG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<HD, SEG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const int rows = kThreads / 32;
    const dim3 dgrid((a.Sq + rows - 1) / rows, a.H, a.B);
    bwd_delta_kernel<__nv_bfloat16><<<dgrid, kThreads, 0, stream>>>(
        a.o, (const __nv_bfloat16*)a.dout, a.delta, a.os, a.dos, a.H, a.Sq,
        a.hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    using bf = const __nv_bfloat16*;
    const dim3 kvgrid(a.KV, a.B, (a.Sk + 63) / 64 * (HD / 64));
    bwd_dkdv_wgmma_kernel<HD, SEG><<<kvgrid, kWgThreads, smem, stream>>>(
        (bf)a.q, (bf)a.k, (bf)a.v, (bf)a.dout, a.lse, a.delta, a.seg,
        (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, a.qs, a.ks, a.vs, a.dos,
        a.dks, a.dvs, a.H, a.KV, a.Sq, a.Sk, a.scale, a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dq_wgmma_kernel<HD, SEG>
        <<<dim3(a.H, a.B, (a.Sq + 63) / 64), kWgThreads, smem, stream>>>(
        (bf)a.q, (bf)a.k, (bf)a.v, (bf)a.dout, a.lse, a.delta, a.seg,
        (__nv_bfloat16*)a.dq, a.qs, a.ks, a.vs, a.dos, a.dqs, a.H, a.KV,
        a.Sq, a.Sk, a.scale, a.causal);
    return cudaGetLastError();
}

bool rows_aligned(const void* p, Strides st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0
        && st.h % 8 == 0 && st.s % 8 == 0;
}

// the tensor-core kernels take bfloat16 at hd 64 or 128 with 16-byte
// aligned rows (the forward's test); everything else the CUDA-core ones
bool takes_wgmma(int bf16, const Args& a) {
    return bf16 && (a.hd == 64 || a.hd == 128) && rows_aligned(a.q, a.qs)
        && rows_aligned(a.k, a.ks) && rows_aligned(a.v, a.vs)
        && rows_aligned(a.dout, a.dos) && rows_aligned(a.dq, a.dqs)
        && rows_aligned(a.dk, a.dks) && rows_aligned(a.dv, a.dvs);
}

cudaError_t dispatch_wgmma(const Args& a, cudaStream_t stream) {
    const bool seg = a.seg != nullptr;
    if (a.hd == 64)
        return seg ? launch_wgmma<64, true>(a, stream)
                   : launch_wgmma<64, false>(a, stream);
    return seg ? launch_wgmma<128, true>(a, stream)
               : launch_wgmma<128, false>(a, stream);
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
// bfloat16 with hd 64 or 128, 16-byte aligned pointers and strides that
// are multiples of 8 go to the tensor-core kernels, everything else to
// the CUDA-core ones.  Three launches on `stream`; returns the first
// error.
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
    if (takes_wgmma(bf16, a))
        return (int)dispatch_wgmma(a, (cudaStream_t)stream);
    if (bf16) return (int)dispatch<__nv_bfloat16>(a, (cudaStream_t)stream);
    return (int)dispatch<float>(a, (cudaStream_t)stream);
}

}  // extern "C"
