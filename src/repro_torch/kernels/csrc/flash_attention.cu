// Causal or non-causal grouped-query attention, forward, for prefill.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/flash_attention.py : flash_attention
// and computes its function (the plain version is
// kernels/ref.py:flash_attention_ref): o = softmax(q kᵀ / √hd) v per
// query head, KV head = query head / (H / KV), future keys masked with
// the finite NEG_INF = -1e30 when causal.  Queries and keys have their
// own lengths Sq and Sk: a non-causal launch takes any Sk (the
// encoder-decoder's cross attention, Sq prompt rows against Sk encoder
// frames); a causal one needs Sk = Sq.  Scores, the softmax and the
// output accumulator are float32; the output is normalised once at the
// end and cast once to the input type (float32 or bfloat16).
//
// Bound, at the prefill shapes (q [1, 16, L, 128], L <= 512, bf16): the
// bytes of q, k, v and o (6.3 MB at L = 512 with 8 KV heads) take 1.9 µs
// at 3.35 TB/s, the causal products 1.1 µs at 989 TFLOP/s.  What costs
// time is latency: the last query tile walks L / 64 key tiles one after
// another, so each tile's loads, products and softmax sit on the
// critical path.
//
// Two kernels, picked by what the launch can observe:
//
// * bfloat16 with hd 64 or 128 and 16-byte aligned rows: Hopper tensor
//   cores.  One CTA of one warpgroup (4 warps, 64 query rows) per (query
//   tile, query head, batch row), the tiles longest first (blockIdx.z = 0
//   is the last query tile, which walks the most key tiles under the
//   causal mask).  K and V tiles of 64 keys stream through a ring of 3
//   stages in shared memory, loaded by cp.async (16 bytes a thread,
//   rows past S zero-filled) into the 128-byte-swizzled layout wgmma
//   reads, so tiles kt + 1 and kt + 2 arrive while tile kt is
//   multiplied.  cp.async rather than TMA: it takes every strided view
//   the model passes without a tensor map encoded on the host per call.
//   S = Q Kᵀ is wgmma m64n64k16 with Q and K from shared memory
//   (K-major); after the online softmax in registers (scores scaled into
//   log2 units, so exp2 takes the exponentials), O += P V is wgmma
//   m64n{hd}k16 with P from registers (the S accumulator layout is the A
//   fragment layout, so P never leaves them) and V from shared memory as
//   an MN-major B operand.  P is float32, as in the Pallas kernel; it
//   enters the bf16 product as two bfloat16 parts, P ≈ hi + lo with hi =
//   bf16(P) and lo = bf16(P - hi), two wgmma into the same float32
//   accumulator, which carries it to a relative 2^-17 instead of bf16's
//   2^-9; the training forward (STATS) takes a third part, to float32's
//   2^-25: at two parts 0.2 % of its bf16 outputs part from the plain
//   version's, ten times what float32 sums in another order move, and a
//   router's top-k turns such ulps into flipped routes.  A CTA takes
//   112 KB of shared memory and 128 threads of at most 255 registers at
//   hd 128, so two fit an SM (228 KB, 64 K registers) where the grid is
//   larger than the card.
// * float32, or any other head dim (<= 128): CUDA cores.  One CTA of
//   256 threads per (query tile of 64, head, batch row) with Q, K, V and
//   the score tile staged in shared memory as float32; thread (ty, tx)
//   of a 16 x 16 grid owns score rows ty + 16i, columns tx + 16j, and
//   output dims tx + 16j.  It loads each tile synchronously.
//
// Training adds two operands, both null on the serving path (whose
// kernels are the SEG = false instantiations, unchanged): `seg` [B, Sq]
// int32, the packed batch's segment ids (Sk = Sq), which masks every
// key of another segment than its query's, and `lse` [B, H, Sq] float32,
// written when given: each row's log-sum-exp of its scaled scores in
// natural-log units (the CUDA-core kernel's m + ln l; the tensor-core
// kernel's (m + log2 l)·ln 2, its scores being in log2 units), which the
// backward kernel (flash_attention_bwd.cu) reads to rebuild P; and
// `o32`, null or [B, H, Sq, hd] float32 contiguous: the output before
// its cast to bfloat16, from which the backward takes D = rowsum(dO ∘ O)
// as the float32 plain version does (a bf16-rounded O would move D by
// its rounding).  Under
// segments a masked score is -inf rather than NEG_INF: a tile whose keys
// are all masked for a row then leaves its m (finite, from -1e30 up), l
// and accumulator as they were (exp(-inf - m) = 0, alpha = 1), with no
// -inf - -inf.  Every row keeps a key (causal packing: its own), so its
// log-sum-exp is finite.
//
// Both walk the keys in tiles of 64 up to the diagonal when causal
// (tiles wholly above it contribute nothing), keep a running max and
// sum per row and rescale the accumulators by exp(m_old - m_new), and
// mask the tail tiles of queries (past Sq) and keys (past Sk), so any
// lengths work (the Pallas wrapper asserts S % 128 == 0).  The grid
// runs over query tiles, the key loop over key tiles.  Inputs are read
// and the output written by strides, so the model's [B, L, H, hd]
// activations need no transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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
                            + 5 * kBQ);
}

template <typename T, bool SEG, bool STATS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int KV, int Sq,
                 int Sk, int hd, float scale, int causal,
                 const int* __restrict__ seg, float* __restrict__ lse,
                 float* __restrict__ o32) {
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
    int* segq_s = reinterpret_cast<int*>(a_s + kBQ);   // SEG: rows' ids
    int* segk_s = segq_s + kBQ;                        // SEG: keys' ids
    constexpr float kMasked = SEG ? -INFINITY : kNegInf;

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
        Qs[idx] = s < Sq ? to_f(qb[s * qs.s + d]) : 0.0f;
    }
    if (tid < kBQ) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.0f;
        if (SEG) segq_s[tid] = q0 + tid < Sq ? seg[b * Sq + q0 + tid] : -1;
    }
    float acc[4][kNJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.0f;

    const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
    for (int k0 = 0; k0 < kv_end; k0 += kBK) {
        __syncthreads();   // Q staged; the previous tile fully consumed
        for (int idx = tid; idx < kBK * hd; idx += kThreads) {
            const int c = idx / hd, d = idx - c * hd, s = k0 + c;
            const bool ok = s < Sk;
            Ks[c * ldk + d] = ok ? to_f(kb[s * ks.s + d]) : 0.0f;
            Vs[idx] = ok ? to_f(vb[s * vs.s + d]) : 0.0f;
        }
        if (SEG && tid < kBK)
            segk_s[tid] = k0 + tid < Sk ? seg[b * Sq + k0 + tid] : -2;
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
                const bool ok = key < Sk && (!causal || key <= q0 + r)
                    && (!SEG || segq_s[r] == segk_s[c]);
                Ps[r * ldp + c] = ok ? sc[i][j] * scale : kMasked;
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
        if (s >= Sq) continue;
        if (STATS && tx == 0)
            lse[((long)b * H + h) * Sq + s] = m_s[r] + logf(l_s[r]);
        const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
            const int d = tx + 16 * j;
            if (d < hd) {
                ob[s * os.s + d] = from_f<T>(acc[i][j] / denom);
                if (STATS && o32 != nullptr)   // bf16: o32 set, f32: null
                    o32[(((long)b * H + h) * Sq + s) * hd + d] =
                        acc[i][j] / denom;
            }
        }
    }
}

template <typename T, bool SEG, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, int hd, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   int causal, const int* seg, float* lse, float* o32,
                   cudaStream_t stream) {
    const size_t smem = smem_bytes(hd);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, SEG, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    flash_fwd_kernel<T, SEG, STATS><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, qs, ks, vs, os, H, KV,
        Sq, Sk, hd, scale, causal, seg, lse, o32);
    return cudaGetLastError();
}


// ------------------------------------------- tensor-core kernel (Hopper)
constexpr int kWgThreads = 128;    // one warpgroup: 64 query rows
constexpr int kStages = 3;         // K/V tiles in the shared-memory ring
constexpr uint32_t kBlockBytes = 64 * 128;   // 64 rows of 128 bytes

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
// (a, b) ≈ hi + mid + lo as three packed bfloat16 pairs, each rounding
// what the earlier parts leave: P to a relative 2^-25, float32's
__device__ __forceinline__ void split_bf16_3(float a, float b, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    split_bf16(a - hf.x, b - hf.y, mid, lo);
    hi = *reinterpret_cast<uint32_t*>(&h);
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
// K-major (Q, K): 8-row groups 1024 bytes apart (stride), the leading
// offset unused.  MN-major (V): 64-column blocks `lbo` apart (leading),
// 8-row groups 1024 bytes apart (stride).
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

// d[0..63] += A·B for one m64n128k16 step: A from registers (the
// m16n8k16 A-fragment layout per warp), B from shared memory
// (MN-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A tile of 64 rows [row0, row0 + 64) of a [S, HD] bf16 slab (S: the
// slab's length, Sq or Sk) into shared memory at `dst` (1024-byte
// aligned) by cp.async, 16 bytes a thread at a time, rows past S
// zero-filled.  Layout: HD / 64 blocks of 64 rows x
// 128 bytes, 16-byte chunk c of row r at chunk c ^ (r % 8) (the 128-byte
// swizzle wgmma reads), so both the K-major and the MN-major descriptors
// address it.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long stride, int row0, int S) {
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

size_t wgmma_smem_bytes(int hd) {   // Q and kStages K/V tiles, + alignment
    return (size_t)(1 + 2 * kStages) * 64 * hd * 2 + 1024;
}

template <int HD, bool SEG, bool STATS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                       Strides vs, Strides os, int H, int KV, int Sq,
                       int Sk, float scale, int causal,
                       const int* __restrict__ seg, float* __restrict__ lse,
                       float* __restrict__ o32) {
    constexpr uint32_t kTile = 64 * HD * 2;   // bytes of one 64-row tile
    constexpr int kKSteps = HD / 16, kDTiles = HD / 8;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
    // stage s: K at sQ + kTile·(1 + 2s), V right after it

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;   // fragment row group, column
    // the longest query tiles first: with causal masking tile i walks
    // i + 1 key tiles, and blockIdx.z = 0 is scheduled first
    const int n_qt = (Sq + 63) / 64, qt = n_qt - 1 - (int)blockIdx.z;
    const int h = blockIdx.x, b = blockIdx.y, q0 = qt * 64;
    const int kvh = h / (H / KV);
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
    const int n_kt = causal ? qt + 1 : (Sk + 63) / 64;

    // the ring: group 0 carries Q and key tile 0, group j tile j; one
    // group is committed per tile (empty past the last) so that
    // wait_group<kStages - 2> always means "tile kt has landed"
    load_tile<HD>(sQ, qb, qs.s, q0, Sq);
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
        if (j < n_kt) {
            const uint32_t sK = sQ + kTile * (1 + 2 * j);
            load_tile<HD>(sK, kb, ks.s, j * 64, Sk);
            load_tile<HD>(sK + kTile, vb, vs.s, j * 64, Sk);
        }
        cp_async_commit();
    }

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    // this thread's rows: qr0 (fragment entries 0, 1) and qr0 + 8 (2, 3)
    const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    // SEG: the rows' segment ids (-1 past Sq: no key matches)
    const int* segb = SEG ? seg + (long)b * Sq : nullptr;
    const int sq0 = SEG && qr0 < Sq ? segb[qr0] : -1;
    const int sq1 = SEG && qr1 < Sq ? segb[qr1] : -1;

    const float scale2 = scale * 1.4426950408889634f;
    for (int kt = 0; kt < n_kt; ++kt) {
        cp_async_wait<kStages - 2>();
        fence_proxy_async();
        __syncthreads();   // tile kt landed; tile kt - 1 fully consumed
        {
            const int j = kt + kStages - 1;
            if (j < n_kt) {
                const uint32_t sK = sQ + kTile * (1 + 2 * (j % kStages));
                load_tile<HD>(sK, kb, ks.s, j * 64, Sk);
                load_tile<HD>(sK + kTile, vb, vs.s, j * 64, Sk);
            }
            cp_async_commit();
        }
        const uint32_t sK = sQ + kTile * (1 + 2 * (kt % kStages));
        const uint32_t sV = sK + kTile;
        const int k0 = kt * 64;

        // S = Q Kᵀ: HD / 16 steps of m64n64k16, both operands K-major
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
            const uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
            wgmma_ss_n64(sc, sw128_desc(sQ + off, 16, 1024),
                         sw128_desc(sK + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // sc[4j + e]: row qr0 (e < 2) or qr1, key k0 + 8j + 2t + (e & 1)
        float mx0 = kNegInf, mx1 = kNegInf;
        const bool masked = SEG || (causal && kt == qt) || k0 + 64 > Sk;
        constexpr float kMasked = SEG ? -INFINITY : kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& s0 = sc[4 * j + e];
                float& s1 = sc[4 * j + 2 + e];
                s0 *= scale2;
                s1 *= scale2;
                if (masked) {
                    const int key = k0 + j * 8 + 2 * t + e;
                    const int sk = SEG && key < Sk ? __ldg(segb + key) : -2;
                    if (key >= Sk || (causal && key > qr0)
                            || (SEG && sk != sq0))
                        s0 = kMasked;
                    if (key >= Sk || (causal && key > qr1)
                            || (SEG && sk != sq1))
                        s1 = kMasked;
                }
                mx0 = fmaxf(mx0, s0);
                mx1 = fmaxf(mx1, s1);
            }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                sc[4 * j + e] = exp2f(sc[4 * j + e] - mn0);
                sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn1);
                rs0 += sc[4 * j + e];
                rs1 += sc[4 * j + 2 + e];
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
            acc[4 * n] *= al0;
            acc[4 * n + 1] *= al0;
            acc[4 * n + 2] *= al1;
            acc[4 * n + 3] *= al1;
        }
        // O += P V: S's accumulator entries 8kk..8kk+7 are the A fragment
        // of key step kk; P's bfloat16 parts one wgmma each, smallest
        // first (two serving, three training: STATS), V an MN-major B
        // operand (16 keys = 2048 bytes a step)
        constexpr int kParts = STATS ? 3 : 2;
        uint32_t pp[kParts][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const float* p = sc + 8 * kk;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if constexpr (STATS)
                    split_bf16_3(p[2 * i], p[2 * i + 1], pp[0][kk][i],
                                 pp[1][kk][i], pp[2][kk][i]);
                else
                    split_bf16(p[2 * i], p[2 * i + 1], pp[0][kk][i],
                               pp[1][kk][i]);
            }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dv = sw128_desc(sV + kk * 2048, kBlockBytes, 1024);
#pragma unroll
            for (int part = kParts - 1; part >= 0; --part) {
                if constexpr (HD == 128)
                    wgmma_rs_n128(acc, pp[part][kk], dv);
                else
                    wgmma_rs_n64(acc, pp[part][kk], dv);
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(kFull, l0, off);
        l1 += __shfl_xor_sync(kFull, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    if (STATS && t == 0) {
        constexpr float kLn2 = 0.6931471805599453f;
        float* lb = lse + ((long)b * H + h) * Sq;
        if (qr0 < Sq) lb[qr0] = (m0 + log2f(l0)) * kLn2;
        if (qr1 < Sq) lb[qr1] = (m1 + log2f(l1)) * kLn2;
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
        const int d = n * 8 + 2 * t;
        if (qr0 < Sq)
            *reinterpret_cast<uint32_t*>(ob + qr0 * os.s + d) =
                pack_bf16(acc[4 * n] / d0, acc[4 * n + 1] / d0);
        if (qr1 < Sq)
            *reinterpret_cast<uint32_t*>(ob + qr1 * os.s + d) =
                pack_bf16(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
        if (STATS) {
            float* ob32 = o32 + ((long)b * H + h) * Sq * HD + d;
            if (qr0 < Sq)
                *reinterpret_cast<float2*>(ob32 + (long)qr0 * HD) =
                    make_float2(acc[4 * n] / d0, acc[4 * n + 1] / d0);
            if (qr1 < Sq)
                *reinterpret_cast<float2*>(ob32 + (long)qr1 * HD) =
                    make_float2(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
        }
    }
}

template <int HD, bool SEG, bool STATS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int KV, int Sq, int Sk,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         float scale, int causal, const int* seg, float* lse,
                         float* o32, cudaStream_t stream) {
    const size_t smem = wgmma_smem_bytes(HD);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<HD, SEG, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(H, B, (Sq + 63) / 64);
    flash_fwd_wgmma_kernel<HD, SEG, STATS>
        <<<grid, kWgThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, qs, ks, vs, os, H, KV,
        Sq, Sk, scale, causal, seg, lse, o32);
    return cudaGetLastError();
}

// the instantiation a launch takes: SEG with segment ids, STATS with the
// log-sum-exp (and, for bfloat16, the float32 output) written; the
// serving launch, neither, is the kernel without either
template <int HD>
cudaError_t launch_wgmma_seg(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int KV, int Sq, int Sk,
                             Strides qs, Strides ks, Strides vs, Strides os,
                             float scale, int causal, const int* seg,
                             float* lse, float* o32, cudaStream_t stream) {
#define FA_WGMMA(SEG, STATS)                                                 \
    launch_wgmma<HD, SEG, STATS>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs,  \
                                 os, scale, causal, seg, lse, o32, stream)
    if (lse != nullptr)
        return seg != nullptr ? FA_WGMMA(true, true) : FA_WGMMA(false, true);
    return seg != nullptr ? FA_WGMMA(true, false) : FA_WGMMA(false, false);
#undef FA_WGMMA
}

template <typename T>
cudaError_t launch_seg(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Sk, int hd,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal, const int* seg, float* lse,
                       float* o32, cudaStream_t stream) {
#define FA_CORES(SEG, STATS)                                                 \
    launch<T, SEG, STATS>(q, k, v, o, B, H, KV, Sq, Sk, hd, qs, ks, vs, os, \
                          scale, causal, seg, lse, o32, stream)
    if (lse != nullptr)
        return seg != nullptr ? FA_CORES(true, true) : FA_CORES(false, true);
    return seg != nullptr ? FA_CORES(true, false) : FA_CORES(false, false);
#undef FA_CORES
}

bool rows_aligned(const void* p, Strides st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0
        && st.h % 8 == 0 && st.s % 8 == 0;
}

}  // namespace

extern "C" {

// q [B, H, Sq, hd], k and v [B, KV, Sk, hd], o [B, H, Sq, hd], each
// given by its element strides of (batch, head, sequence) with the head
// dim contiguous.  bf16 != 0: all four are bfloat16, else float32.  hd <=
// 128, H a multiple of KV, Sk >= 1, and Sk = Sq when causal or when
// `seg` is given.  seg: null, or [B, Sq] int32 contiguous segment ids;
// lse: null, or [B, H, Sq] float32 contiguous, written; o32: null, or
// [B, H, Sq, hd] float32 contiguous, the output before its cast, written
// (bfloat16 only, given exactly when lse is: a float32 o is that
// already).  bfloat16 with
// hd 64 or 128, 16-byte aligned pointers and strides that are multiples
// of 8 go to the tensor-core kernel, everything else to the CUDA-core
// one.  Returns cudaGetLastError() of the launch.
int flash_attention_fwd_launch(int bf16, const void* q, const void* k,
                               const void* v, void* o, int B, int H, int KV,
                               int Sq, int Sk, int hd, long qsb, long qsh,
                               long qss, long ksb, long ksh, long kss,
                               long vsb, long vsh, long vss, long osb,
                               long osh, long oss, float scale, int causal,
                               const int* seg, float* lse, float* o32,
                               void* stream) {
    if (B == 0 || H == 0 || Sq == 0) return 0;
    if (hd > kMaxHd || KV == 0 || H % KV != 0 || Sk < 1
            || ((causal || seg != nullptr) && Sk != Sq)
            || (bf16 && (lse == nullptr) != (o32 == nullptr)))
        return (int)cudaErrorInvalidValue;
    const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
        os{osb, osh, oss};
    const cudaStream_t st = (cudaStream_t)stream;
    if (bf16 && (hd == 64 || hd == 128) && rows_aligned(q, qs)
            && rows_aligned(k, ks) && rows_aligned(v, vs)
            && rows_aligned(o, os)) {
        if (hd == 64)
            return (int)launch_wgmma_seg<64>(q, k, v, o, B, H, KV, Sq, Sk,
                                             qs, ks, vs, os, scale, causal,
                                             seg, lse, o32, st);
        return (int)launch_wgmma_seg<128>(q, k, v, o, B, H, KV, Sq, Sk, qs,
                                          ks, vs, os, scale, causal, seg,
                                          lse, o32, st);
    }
    if (bf16)
        return (int)launch_seg<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk,
                                              hd, qs, ks, vs, os, scale,
                                              causal, seg, lse, o32, st);
    return (int)launch_seg<float>(q, k, v, o, B, H, KV, Sq, Sk, hd, qs, ks,
                                  vs, os, scale, causal, seg, lse, nullptr,
                                  st);
}

}  // extern "C"
