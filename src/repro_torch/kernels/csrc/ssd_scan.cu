// Mamba2 SSD chunked scan: y and the final state of the selective scan
//   S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_tᵀ,   y_t = C_tᵀ S_t
// over x [B, L, H, P], dt [B, L, H], A [H], B/C [B, L, N] (one B/C group).
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py : ssd_scan
// and computes what its plain version, `ssd_chunked`
// (src/repro_torch/models/layers/ssd.py), computes: within a chunk the
// causal quadratic term (C Bᵀ ⊙ exp(cum_i - cum_j) ⊙ dt_j) x, the mask
// applied before the exponential; the state read through C and scaled
// by exp(cum_i); the state carried from chunk to chunk as
// exp(total) S + Σ_j exp(total - cum_j) dt_j B_j x_jᵀ.  Float32
// throughout; x, B and C read in their dtype (bfloat16 or float32), y
// written in x's dtype, the final state [B, H, N, P] in float32, from an
// optional float32 initial state (zero when absent).
//
// Design.  The Pallas grid walks the chunks of one (batch, head block) in
// order and keeps the state in VMEM scratch across grid steps.  Here one
// CTA takes one (batch row, head, 16 columns of P) and loops over the
// chunks itself, the state [N, 16] in shared memory.  The columns of P
// are independent (y[:, h, p] and S[h, :, p] read x only at column p),
// so the grid (P/16, H, B) needs no reduction across CTAs and gives 96
// CTAs at B = 1 on Mamba2-130M (H 24, P 64).  The kernel runs its own
// chunk of 64 tokens, whatever chunk the caller's contract names: the
// same SSD with its decays taken from other cumulative sums, so it
// differs from `ssd_chunked` at chunk 256 by float32 rounding only.  At
// 64 the transposed B and C tiles ([N, 64] float32, 34 KB each at
// N = 128) and the causal weight tile [64, 64] fit in shared memory
// (~99 KB a CTA); at 256 one B tile alone would be 128 KB and the weight
// tile 256 KB.  Any L: rows past L read as zero (dt = 0 keeps the decay
// at 1 and adds nothing).
//
// Bound: operations.  For one chunk of Q tokens a CTA computes the
// causal C·Bᵀ tile (Q²/2·N multiply-adds, recomputed by each of the
// (P/16)·H CTAs of a batch row), the intra-chunk product (Q²/2·16), the
// state read (Q·N·16) and the state update (Q·N·16), all on CUDA cores
// from shared memory; the bytes (x and y once, B and C once per CTA,
// from L2 after the first) are a few MB.  The tensor cores (C·Bᵀ and
// W·x as bf16 mma with float32 sums), B/C shared across the heads of a
// CTA and asynchronous tile loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;        // the kernel's own chunk
constexpr int kPB = 16;       // columns of P a CTA takes
constexpr int kQS = kQ + 4;   // row stride of the transposed B/C tiles
constexpr int kWS = kQ + 1;   // row stride of the weight tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
    return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

size_t smem_bytes(int N) {
    return sizeof(float) *
           (2 * (size_t)N * kQS + kQ * kWS + kQ * kPB + (size_t)N * kPB +
            3 * kQ + 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ fin, int L, int H,
                int P, int N) {
    extern __shared__ float4 smem4[];
    float* Bt = reinterpret_cast<float*>(smem4);   // [N][kQS]  B of the chunk
    float* Ct = Bt + (size_t)N * kQS;              // [N][kQS]  C of the chunk
    float* W = Ct + (size_t)N * kQS;               // [kQ][kWS] causal weights
    float* xs = W + kQ * kWS;                      // [kQ][kPB] x of the chunk
    float* S = xs + kQ * kPB;                      // [N][kPB]  the state
    float* cum = S + (size_t)N * kPB;              // [kQ] in-chunk cumsum of dt A
    float* dts = cum + kQ;                         // [kQ] dt
    float* zq = dts + kQ;                          // [kQ] exp(total - cum) dt
    float* tot = zq + kQ;                          // [1]  cum of the last row

    const int tid = threadIdx.x;
    const int p0 = blockIdx.x * kPB;
    const int h = blockIdx.y;
    const long b = blockIdx.z;
    const float a = A[h];

    for (int i = tid; i < N * kPB; i += kThreads) {
        const int n = i / kPB, p = i % kPB;
        S[i] = (init != nullptr && p0 + p < P)
                   ? init[((b * H + h) * N + n) * P + p0 + p]
                   : 0.0f;
    }

    for (int t0 = 0; t0 < L; t0 += kQ) {
        const int q_len = min(kQ, L - t0);
        // ---- the chunk's dt, x, B, C; rows past L are zero.  The loops
        // are unrolled so that a thread's loads are in flight together
        // rather than each waiting on L2 in turn ---------------------------
        if (tid < kQ)
            dts[tid] = tid < q_len ? dt[(b * L + t0 + tid) * H + h] : 0.0f;
#pragma unroll 4
        for (int i = tid; i < kQ * kPB; i += kThreads) {
            const int q = i / kPB, p = i % kPB;
            xs[i] = (q < q_len && p0 + p < P)
                        ? to_f(x[((b * L + t0 + q) * H + h) * P + p0 + p])
                        : 0.0f;
        }
#pragma unroll 8
        for (int i = tid; i < kQ * N; i += kThreads) {
            const int q = i / N, n = i % N;
            float bv = 0.0f, cv = 0.0f;
            if (q < q_len) {
                const long o = (b * L + t0 + q) * N + n;
                bv = to_f(Bm[o]);
                cv = to_f(Cm[o]);
            }
            Bt[n * kQS + q] = bv;
            Ct[n * kQS + q] = cv;
        }
        __syncthreads();
        // ---- inclusive cumsum of dt A over the chunk, left to right in
        // one thread (64 dependent adds: a few hundred cycles of a chunk's
        // ~10^4); rows past L add exactly 0, so `total` is the cum of the
        // chunk's last row ------------------------------------------------
        if (tid == 0) {
            float run = 0.0f;
#pragma unroll 16
            for (int q = 0; q < kQ; ++q) {
                run = __fadd_rn(run, __fmul_rn(dts[q], a));
                cum[q] = run;
            }
            tot[0] = run;
        }
        __syncthreads();
        const float total = tot[0];
        if (tid < kQ) zq[tid] = expf(total - cum[tid]) * dts[tid];

        // ---- W[i][j] = (C_i · B_j) exp(cum_i - cum_j) dt_j for i >= j,
        // 0 above the diagonal (never exponentiated); a 4x4 tile a thread
        {
            const int ti = tid / 16, tj = tid % 16;
            float acc[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
            if (tj <= ti) {
                for (int n = 0; n < N; ++n) {
                    const float4 c4 =
                        *reinterpret_cast<const float4*>(&Ct[n * kQS + 4 * ti]);
                    const float4 b4 =
                        *reinterpret_cast<const float4*>(&Bt[n * kQS + 4 * tj]);
                    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
                    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = 4 * ti + r;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = 4 * tj + c;
                    W[i * kWS + j] =
                        i >= j ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j]
                               : 0.0f;
                }
            }
        }
        __syncthreads();

        // ---- y_i = Σ_{j<=i} W[i][j] x_j + exp(cum_i) C_i · S_prev:
        // one row and 4 columns a thread ---------------------------------
        {
            const int i = tid / 4, pc = (tid % 4) * 4;
            float yi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float yo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int j = 0; j <= i; ++j) {
                const float w = W[i * kWS + j];
                const float4 xv =
                    *reinterpret_cast<const float4*>(&xs[j * kPB + pc]);
                yi[0] = fmaf(w, xv.x, yi[0]);
                yi[1] = fmaf(w, xv.y, yi[1]);
                yi[2] = fmaf(w, xv.z, yi[2]);
                yi[3] = fmaf(w, xv.w, yi[3]);
            }
            for (int n = 0; n < N; ++n) {
                const float c = Ct[n * kQS + i];
                const float4 sv =
                    *reinterpret_cast<const float4*>(&S[n * kPB + pc]);
                yo[0] = fmaf(c, sv.x, yo[0]);
                yo[1] = fmaf(c, sv.y, yo[1]);
                yo[2] = fmaf(c, sv.z, yo[2]);
                yo[3] = fmaf(c, sv.w, yo[3]);
            }
            if (i < q_len) {
                const float e = expf(cum[i]);
                T* yrow = y + ((b * L + t0 + i) * H + h) * P + p0 + pc;
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (p0 + pc + k < P) yrow[k] = from_f<T>(yi[k] + yo[k] * e);
            }
        }
        __syncthreads();   // every read of the previous state is done

        // ---- S <- exp(total) S + Σ_j (B_j exp(total - cum_j) dt_j) x_jᵀ:
        // one state row and 8 columns a thread --------------------------
        {
            const float et = expf(total);
            for (int it = tid; it < 2 * N; it += kThreads) {
                const int n = it / 2, pc = (it % 2) * 8;
                float acc[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
                for (int j = 0; j < q_len; ++j) {
                    const float bz = Bt[n * kQS + j] * zq[j];
                    const float4 x0 =
                        *reinterpret_cast<const float4*>(&xs[j * kPB + pc]);
                    const float4 x1 =
                        *reinterpret_cast<const float4*>(&xs[j * kPB + pc + 4]);
                    acc[0] = fmaf(bz, x0.x, acc[0]);
                    acc[1] = fmaf(bz, x0.y, acc[1]);
                    acc[2] = fmaf(bz, x0.z, acc[2]);
                    acc[3] = fmaf(bz, x0.w, acc[3]);
                    acc[4] = fmaf(bz, x1.x, acc[4]);
                    acc[5] = fmaf(bz, x1.y, acc[5]);
                    acc[6] = fmaf(bz, x1.z, acc[6]);
                    acc[7] = fmaf(bz, x1.w, acc[7]);
                }
                float* srow = S + n * kPB + pc;
#pragma unroll
                for (int k = 0; k < 8; ++k) srow[k] = srow[k] * et + acc[k];
            }
        }
        __syncthreads();   // the next chunk overwrites the tiles
    }

    for (int i = tid; i < N * kPB; i += kThreads) {
        const int n = i / kPB, p = i % kPB;
        if (p0 + p < P) fin[((b * H + h) * N + n) * P + p0 + p] = S[i];
    }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* init,
                     void* y, void* fin, int B, int L, int H, int P, int N,
                     cudaStream_t stream) {
    const size_t smem = smem_bytes(N);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((P + kPB - 1) / kPB, H, B);
    ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const float*>(init),
        static_cast<T*>(y), static_cast<float*>(fin), L, H, P, N);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, L, H, P], B/C [B, L, N] and y [B, L, H, P] contiguous, bfloat16
// when bf16 != 0 else float32; dt [B, L, H], A [H], init (or null) and
// fin [B, H, N, P] contiguous float32.  N <= 256.  Returns the CUDA error
// of the launch (0 on success).
int ssd_scan_launch(int bf16, const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* init,
                    void* y, void* fin, int B, int L, int H, int P, int N,
                    void* stream) {
    if (B == 0 || H == 0 || P == 0) return 0;
    if (N <= 0 || N > 256) return (int)cudaErrorInvalidValue;
    if (bf16)
        return (int)launch_t<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, fin,
                                            B, L, H, P, N,
                                            (cudaStream_t)stream);
    return (int)launch_t<float>(x, dt, A, Bm, Cm, init, y, fin, B, L, H, P,
                                N, (cudaStream_t)stream);
}

}  // extern "C"
