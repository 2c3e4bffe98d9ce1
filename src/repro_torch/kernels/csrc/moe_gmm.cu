// Grouped (per-expert) matrix product of the MoE FFN:
//   out[e] = x[e] @ w[e],   x [E, C, D], w [E, D, F] -> out [E, C, F].
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/moe_gmm.py : moe_gmm
// and computes its function (the plain version is
// kernels/ref.py:moe_gmm_ref): products summed in float32 over D, one
// cast of each sum to the input type (float32 or bfloat16).  Unlike the
// Pallas kernel, which asserts C, D and F to be multiples of its tiles,
// it takes any E, C, D and F: tail rows, columns and depths are masked.
//
// What bounds it on the H100: bytes.  Every launch of the MoE layer
// reads one layer's expert weight, 64 x 2048 x 1024 bf16 = 268 MB for
// OLMoE (0.080 ms at 3.35 TB/s), against at most 21.5 GFLOP at the
// prefill's capacity C = 80 (0.022 ms on the tensor cores) and 1.07
// GFLOP at the decode step's C = 4.  So each CTA holds every row of x
// (up to kMaxM) and reads its tile of w exactly once: one CTA per
// (expert, 64 columns of F), looping over D in blocks of 64.
//
// Two kernels, picked by what the launch can observe:
//
// * bfloat16 with D and F multiples of 8 and 16-byte aligned pointers:
//   tensor cores.  4 warps; each owns 16 columns (two n8 tiles) and all
//   rows of the CTA, in m16n8k16 mma.sync tiles (bf16 in, f32
//   accumulate; the products of two bf16 are exact in f32, so this is
//   the float32 sum of the Pallas kernel in another order).  The x and
//   w tiles stream through a ring of kStages shared-memory buffers with
//   cp.async (16 bytes a thread, zero-filled past C and D), so the next
//   tiles' loads are in flight while the current one is multiplied.
// * float32, or bfloat16 that is not so aligned: CUDA cores.  256
//   threads; thread (ty, tx) of a 16 x 16 grid sums rows ty + 16i and
//   columns tx + 16j with float32 FMAs over tiles of 32 depths staged
//   in shared memory as float32 (synchronous loads, any shape).  TF32
//   would not keep the float32 sums of the reference, so float32 does
//   not use the tensor cores.
//
// C beyond kMaxM rows splits over CTAs (grid.y), which then read w once
// each; the MoE path's C stays at or below 80.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 128;        // rows of x a CTA holds
constexpr int kBN = 64;           // columns of F a CTA computes

// ------------------------------------------------- tensor-core kernel
constexpr int kMmaThreads = 128;  // 4 warps x 16 columns
constexpr int kBD = 64;           // depth of one staged tile
constexpr int kStages = 3;
constexpr int kLdX = kBD + 8;     // bf16 row pitch of the x tile
constexpr int kLdW = kBN + 8;     // bf16 row pitch of the w tile
constexpr int kMT = kMaxM / 16;   // m16 tiles at most

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo)
        | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
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
// 16 bytes global -> shared, asynchronous; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

size_t mma_smem_bytes(int mpad) {
    return sizeof(__nv_bfloat16) * kStages
        * ((size_t)mpad * kLdX + (size_t)kBD * kLdW);
}

// stage the depth block [d0, d0 + kBD) of x rows [0, mpad) and of w
// columns [n0, n0 + kBN) into one ring buffer
__device__ __forceinline__ void stage_tiles(
        __nv_bfloat16* Xs, __nv_bfloat16* Ws, const __nv_bfloat16* xe,
        const __nv_bfloat16* we, int rows, int mpad, int d0, int n0, int D,
        int F) {
    constexpr int kChunks = kBD / 8;
    for (int idx = threadIdx.x; idx < mpad * kChunks; idx += kMmaThreads) {
        const int r = idx / kChunks, c = idx - r * kChunks, d = d0 + c * 8;
        const bool ok = r < rows && d < D;
        cp_async16(Xs + r * kLdX + c * 8,
                   ok ? xe + (long)r * D + d : xe, ok);
    }
    constexpr int kWChunks = kBN / 8;
    for (int idx = threadIdx.x; idx < kBD * kWChunks; idx += kMmaThreads) {
        const int k = idx / kWChunks, c = idx - k * kWChunks;
        const int d = d0 + k, n = n0 + c * 8;
        const bool ok = d < D && n < F;
        cp_async16(Ws + k * kLdW + c * 8,
                   ok ? we + (long)d * F + n : we, ok);
    }
}

__global__ void __launch_bounds__(kMmaThreads)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ o, int C, int D, int F) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * kMaxM;
    const int e = blockIdx.z;
    const int rows = min(kMaxM, C - c0);
    const int n_mt = (rows + 15) / 16, mpad = n_mt * 16;
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Ws = Xs + kStages * mpad * kLdX;
    const __nv_bfloat16* xe = x + ((long)e * C + c0) * D;
    const __nv_bfloat16* we = w + (long)e * D * F;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;   // mma row group, thread in it
    float acc[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
            acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
                acc[mt][nt][3] = 0.0f;

    const int nk = (D + kBD - 1) / kBD;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk)
            stage_tiles(Xs + s * mpad * kLdX, Ws + s * kBD * kLdW, xe, we,
                        rows, mpad, s * kBD, n0, D, F);
        cp_async_commit();
    }
    for (int kb = 0; kb < nk; ++kb) {
        cp_async_wait<kStages - 2>();   // block kb has landed (this thread)
        __syncthreads();                // ... for every thread; block kb-1
                                        // is consumed by every warp
        const int nxt = kb + kStages - 1;
        if (nxt < nk) {
            const int s = nxt % kStages;
            stage_tiles(Xs + s * mpad * kLdX, Ws + s * kBD * kLdW, xe, we,
                        rows, mpad, nxt * kBD, n0, D, F);
        }
        cp_async_commit();
        const int s = kb % kStages;
        const __nv_bfloat16* xs = Xs + s * mpad * kLdX;
        const __nv_bfloat16* ws = Ws + s * kBD * kLdW;
#pragma unroll
        for (int kk = 0; kk < kBD / 16; ++kk) {
            // B fragments of this warp's two n8 tiles: w[k][n] with
            // k = 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1), n = g
            uint32_t b0[2], b1[2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const __nv_bfloat16* wp =
                    ws + (kk * 16 + 2 * t) * kLdW + warp * 16 + nt * 8 + g;
                b0[nt] = pack_raw(wp[0], wp[kLdW]);
                b1[nt] = pack_raw(wp[8 * kLdW], wp[9 * kLdW]);
            }
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
                if (mt < n_mt) {
                    const __nv_bfloat16* xp =
                        xs + (mt * 16 + g) * kLdX + kk * 16 + 2 * t;
                    uint32_t a[4];
                    a[0] = ld32(xp);
                    a[1] = ld32(xp + 8 * kLdX);
                    a[2] = ld32(xp + 8);
                    a[3] = ld32(xp + 8 * kLdX + 8);
                    mma_bf16(acc[mt][0], a, b0[0], b1[0]);
                    mma_bf16(acc[mt][1], a, b0[1], b1[1]);
                }
            }
        }
    }
    cp_async_wait<0>();

    __nv_bfloat16* oe = o + ((long)e * C + c0) * F;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= n_mt) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            const int col = n0 + warp * 16 + nt * 8 + 2 * t;
            const int r0 = mt * 16 + g, r1 = r0 + 8;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                if (col + j >= F) continue;
                if (r0 < rows)
                    oe[(long)r0 * F + col + j] =
                        __float2bfloat16(acc[mt][nt][j]);
                if (r1 < rows)
                    oe[(long)r1 * F + col + j] =
                        __float2bfloat16(acc[mt][nt][2 + j]);
            }
        }
    }
}

// ----------------------------------------------------- CUDA-core kernel
constexpr int kSimtThreads = 256;
constexpr int kSD = 32;           // depth of one staged tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
gmm_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ o, int C, int D, int F) {
    __shared__ float Xs[kMaxM][kSD + 1];
    __shared__ float Ws[kSD][kBN];
    const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * kMaxM;
    const int e = blockIdx.z;
    const int rows = min(kMaxM, C - c0);
    const T* xe = x + ((long)e * C + c0) * D;
    const T* we = w + (long)e * D * F;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    constexpr int kRI = kMaxM / 16;
    float acc[kRI][4];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += kSD) {
        __syncthreads();   // the previous tiles fully consumed
        for (int idx = tid; idx < rows * kSD; idx += kSimtThreads) {
            const int r = idx / kSD, k = idx - r * kSD, d = d0 + k;
            Xs[r][k] = d < D ? to_f(xe[(long)r * D + d]) : 0.0f;
        }
        for (int idx = tid; idx < kSD * kBN; idx += kSimtThreads) {
            const int k = idx / kBN, n = idx - k * kBN;
            const int d = d0 + k, col = n0 + n;
            Ws[k][n] = (d < D && col < F) ? to_f(we[(long)d * F + col])
                                          : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kSD; ++k) {
            float wv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[j] = Ws[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kRI; ++i) {
                if (ty + 16 * i < rows) {
                    const float xv = Xs[ty + 16 * i][k];
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
                }
            }
        }
    }

    T* oe = o + ((long)e * C + c0) * F;
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx + 16 * j;
            if (col < F) oe[(long)r * F + col] = from_f<T>(acc[i][j]);
        }
    }
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x [E, C, D], w [E, D, F] and out [E, C, F], all contiguous, one type:
// bf16 != 0 bfloat16, else float32.  bfloat16 with D and F multiples of
// 8 and 16-byte aligned pointers goes to the tensor-core kernel, the
// rest to the CUDA-core one.  Returns cudaGetLastError() of the launch.
int moe_gmm_launch(int bf16, const void* x, const void* w, void* out,
                   int E, int C, int D, int F, void* stream) {
    if (E == 0 || C == 0 || F == 0) return 0;
    const dim3 grid((F + kBN - 1) / kBN, (C + kMaxM - 1) / kMaxM, E);
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16 && D % 8 == 0 && F % 8 == 0 && aligned16(x) && aligned16(w)
            && aligned16(out)) {
        const int mpad = ((C < kMaxM ? C : kMaxM) + 15) / 16 * 16;
        const size_t smem = mma_smem_bytes(mpad);
        cudaError_t err = cudaFuncSetAttribute(
            gmm_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)mma_smem_bytes(kMaxM));
        if (err != cudaSuccess) return (int)err;
        gmm_mma_kernel<<<grid, kMmaThreads, smem, st>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
            (__nv_bfloat16*)out, C, D, F);
        return (int)cudaGetLastError();
    }
    if (bf16)
        gmm_simt_kernel<__nv_bfloat16><<<grid, kSimtThreads, 0, st>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
            (__nv_bfloat16*)out, C, D, F);
    else
        gmm_simt_kernel<float><<<grid, kSimtThreads, 0, st>>>(
            (const float*)x, (const float*)w, (float*)out, C, D, F);
    return (int)cudaGetLastError();
}

}  // extern "C"
