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
// exp(total) S + Σ_j exp(total - cum_j) dt_j B_j x_jᵀ.  x, B and C are
// read in their dtype (bfloat16 or float32), y written in x's dtype, the
// final state [B, H, N, P] in float32, from an optional float32 initial
// state (zero when absent).
//
// Design: the SSD block decomposition (arXiv:2405.21060 §6), three
// launches, so that the chunks run in parallel instead of in series.
//
//   1. ssd_scan_states   grid (chunk, head group · P block, batch row):
//      the chunk-local state S_loc = Σ_j exp(total - cum_j) dt_j B_j x_jᵀ
//      of each head of the group, and the chunk's `total`, into a float32
//      scratch the wrapper allocates.
//   2. ssd_scan_handoff  one thread a (batch row, head, state row, 4
//      columns): S_c = exp(total_c) S_{c-1} + S_loc_c in chunk order from
//      the initial state, storing the state that enters each chunk (in
//      the layout the output kernel stages) and the final state.  It is
//      elementwise over [H, N, P]; its loads of all chunks are issued
//      before the first update.
//   3. ssd_scan_output   grid as 1: y = W x + exp(cum) C S_in, with
//      W = C Bᵀ ⊙ exp(cum_i - cum_j) ⊙ dt_j, j <= i.  C Bᵀ depends only
//      on the batch row and the chunk: each CTA computes it once and
//      shares it across the heads of its group.
//
// The kernel's chunk Q is 64 tokens, whatever chunk the caller's
// contract names: the same SSD with its decays taken from other
// cumulative sums, so it differs from `ssd_chunked` at chunk 256 by
// float32 rounding only.  64 because (a) the intra-chunk work grows with
// Q per token and the grid with L / Q, so at Mamba2-130M's L = 512 a
// chunk of 64 gives 8 chunks × 12 head groups; 128 would give half the
// CTAs and twice the quadratic work; (b) four m16 row tiles of 16 and
// four k16 tiles make C Bᵀ, W x and the state products whole tensor-core
// tiles; (c) the B and C tiles (bf16, [64][N + 8]) are 17 KB each at
// N = 128, so a CTA with two heads stays under 100 KB and two CTAs fit
// an SM.  P is taken in blocks of 64 columns (all of Mamba2's 64).
// Rows past L read as zero (dt = 0 keeps the decay at 1, adds nothing).
// Any L, N <= 256, any P.
//
// bfloat16: every product on tensor cores (mma.sync m16n8k16, bf16 in,
// float32 sums).  x, B and C are exact in bf16; W, z⊙x and the entering
// state are float32, so each is split into a bf16 high part and a bf16
// low part (v = hi + lo to ~2^-17 relative) and multiplied twice.  C Bᵀ
// stays in registers as the accumulator of the W x product's A operand
// (the m16n8 accumulator layout is the m16k16 operand layout).  Tiles
// come in by cp.async 16-byte copies (zero-filled past L), the next
// head's entering state while this head's W x runs.
// float32: the same three launches and the shared C Bᵀ on CUDA cores,
// each product an FMA chain along N or along the chunk in index order,
// the in-chunk cumsum in sequential order (bf16: a warp scan), and the
// hand-off in chunk order.
//
// Bound, at Mamba2-130M's L = 512 (H 24, P 64, N 128): the chunked SSD
// at Q = 64 is 0.46 GFLOP (the causal C Bᵀ, W x, the state read and
// update) against ~4.2 MB of inputs and outputs.  float32 is bound by
// operations, 6.8 µs at the card's 67 TFLOP/s on CUDA cores; bf16, its
// products on tensor cores (989 TFLOP/s), by bytes, ~1.3 µs at 3.35 TB/s.
// What sets the time is latency: three launches, a chunk's loads, its
// chain of dependent products, and the hand-off's pass over the chunk
// states (6.3 MB of float32 at L = 512, from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 64;            // the kernel's chunk
constexpr int kPB = 64;           // columns of P a CTA takes
constexpr int kMaxHeads = 4;      // heads a CTA (its group)
constexpr int kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
    return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Row strides (elements) of the shared tiles: B and C [kQ][np + pad],
// x, z⊙x and the entering state [..][kPB + pad].  The pad (16 bytes)
// puts the 8 rows an ldmatrix or a quarter-warp's float4 reads in 8
// different bank groups.
template <typename T> struct Layout {
    static constexpr int kPad = 16 / sizeof(T);
    int np, heads;
    __host__ __device__ Layout(int N, int h) : np(round16(N)), heads(h) {}
    __host__ __device__ int bc_stride() const { return np + kPad; }
    __host__ __device__ static constexpr int x_stride() { return kPB + kPad; }
    __host__ __device__ size_t bc_bytes() const {
        return sizeof(T) * (size_t)kQ * bc_stride();
    }
    __host__ __device__ size_t x_bytes() const {
        return sizeof(T) * (size_t)kQ * x_stride();
    }
    // the entering state: bf16 high and low planes, or one float32 plane
    __host__ __device__ size_t s_bytes() const {
        return (sizeof(T) == 2 ? 2 : 1) * sizeof(T) * (size_t)np * x_stride();
    }
    // ssd_scan_states: B, x of each head, (bf16) z⊙x high and low, z
    __host__ __device__ size_t states_bytes() const {
        return bc_bytes() + heads * x_bytes() +
               (sizeof(T) == 2 ? 2 * x_bytes() : 0) +
               sizeof(float) * (size_t)heads * kQ;
    }
    // ssd_scan_output: C, B or the entering state (one region, B is dead
    // once C Bᵀ is formed), x of each head, (float32) W, cum and dt
    __host__ __device__ size_t region_bytes() const {
        return bc_bytes() > s_bytes() ? bc_bytes() : s_bytes();
    }
    __host__ __device__ size_t w_bytes() const {
        return sizeof(T) == 2 ? 0 : sizeof(float) * (size_t)kQ * (kQ + 1);
    }
    __host__ __device__ size_t output_bytes() const {
        return bc_bytes() + region_bytes() + heads * x_bytes() + w_bytes() +
               2 * sizeof(float) * (size_t)heads * kQ;
    }
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 zero bytes when !full (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}
// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// v = hi + lo, both bf16; the pair (v0, v1) packed with v0 in the low half
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ------------------------------------------------------------- tiles
// rows x cols of T from global (row stride `ld`) to shared (row stride
// `sd`); zero where r >= rows_ok or c >= cols_ok.  `vec`: 16-byte
// cp.async copies (caller commits and waits; every 16-byte piece is
// wholly valid or wholly out); else plain loads and stores.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int sd, const T* src,
                                          long ld, int rows, int cols,
                                          int rows_ok, int cols_ok,
                                          bool vec) {
    if (vec) {
        constexpr int E = 16 / sizeof(T);
        const int per_row = cols / E;
        for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
            const int r = i / per_row, c = (i % per_row) * E;
            const bool ok = r < rows_ok && c < cols_ok;
            cp_async16(dst + r * sd + c, ok ? src + r * ld + c : src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
            const int r = i / cols, c = i % cols;
            dst[r * sd + c] = (r < rows_ok && c < cols_ok)
                                  ? src[r * ld + c]
                                  : from_f<T>(0.0f);
        }
    }
}

// The chunk's inclusive cumsum of dt·a for one head, by one warp: lane l
// gets rows 2l and 2l + 1 (dt = 0 past q_len, so those rows repeat the
// last sum).  Returns the total (row kQ - 1).  A Kogge-Stone scan, or,
// when `ordered`, the one sum ((a_0 + a_1) + a_2) + ... that a single
// thread would take, run by every lane: float32 takes that order, since
// the scan's other rounding moves the float32 Mamba2 serve measurably
// nearer the golden's limit (PERF.md); bf16's products round far more.
__device__ __forceinline__ float warp_cumsum(const float* __restrict__ dt,
                                             long off, int H, int q_len,
                                             float a, float& cum0,
                                             float& cum1, float& d0,
                                             float& d1, bool ordered) {
    const int lane = threadIdx.x & 31;
    const int r0 = 2 * lane, r1 = r0 + 1;
    d0 = r0 < q_len ? dt[off + (long)r0 * H] : 0.0f;
    d1 = r1 < q_len ? dt[off + (long)r1 * H] : 0.0f;
    const float a0 = __fmul_rn(d0, a), a1 = __fmul_rn(d1, a);
    if (ordered) {
        float acc = 0.0f;
        for (int l = 0; l < 32; ++l) {
            acc = __fadd_rn(acc, __shfl_sync(kFull, a0, l));
            if (lane == l) cum0 = acc;
            acc = __fadd_rn(acc, __shfl_sync(kFull, a1, l));
            if (lane == l) cum1 = acc;
        }
        return acc;
    }
    float run = __fadd_rn(a0, a1);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(kFull, run, o);
        if (lane >= o) run = __fadd_rn(run, v);
    }
    float excl = __shfl_up_sync(kFull, run, 1);
    if (lane == 0) excl = 0.0f;
    cum0 = __fadd_rn(excl, a0);
    cum1 = run;
    return __shfl_sync(kFull, run, 31);
}

struct Cta {      // what blockIdx names in ssd_scan_states / _output
    int c, t0, q_len, h0, nh, pb, p0, p_ok;
    long b;
    __device__ Cta(int L, int H, int P, int heads) {
        const int npb = (P + kPB - 1) / kPB;
        c = blockIdx.x;
        t0 = c * kQ;
        q_len = min(kQ, L - t0);
        h0 = (blockIdx.y / npb) * heads;
        nh = min(heads, H - h0);
        pb = blockIdx.y % npb;
        p0 = pb * kPB;
        p_ok = min(kPB, P - p0);
        b = blockIdx.z;
    }
};

// float offset of the [np][kPB] block (b, chunk c, head h, P block pb)
// of the chunk-state scratch (and of the entering-state scratch)
__device__ __forceinline__ long slot(long b, int c, int nc, int h, int H,
                                     int pb, int npb, int np) {
    return ((((b * nc + c) * H + h) * (long)npb + pb) * np) * kPB;
}

// ============================================== 1. chunk-local states
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_states(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ totals,
                int L, int H, int P, int N, int heads, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout<T> lay(N, heads);
    const int np = lay.np, bcs = lay.bc_stride();
    constexpr int xs_ = Layout<T>::x_stride();
    T* Bs = reinterpret_cast<T*>(smem);                       // [kQ][bcs]
    T* xs = reinterpret_cast<T*>(smem + lay.bc_bytes());      // [nh][kQ][xs_]
    unsigned char* after_x = smem + lay.bc_bytes() + heads * lay.x_bytes();
    float* zq = reinterpret_cast<float*>(
        after_x + (sizeof(T) == 2 ? 2 * lay.x_bytes() : 0));  // [nh][kQ]
    const Cta k(L, H, P, heads);
    const int nc = (L + kQ - 1) / kQ, npb = (P + kPB - 1) / kPB;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    load_tile(Bs, bcs, Bm + (k.b * L + k.t0) * N, N, kQ, np, k.q_len, N,
              vec);
    for (int hh = 0; hh < k.nh; ++hh)
        load_tile(xs + hh * kQ * xs_, xs_,
                  x + ((k.b * L + k.t0) * H + k.h0 + hh) * (long)P + k.p0,
                  (long)H * P, kQ, kPB, k.q_len, k.p_ok, vec);
    cp_async_commit();
    // z_j = exp(total - cum_j) dt_j, one warp a head
    for (int hh = warp; hh < k.nh; hh += kWarps) {
        const int h = k.h0 + hh;
        float c0, c1, d0, d1;
        const float total = warp_cumsum(dt, k.b * L * H + (long)k.t0 * H + h,
                                        H, k.q_len, A[h], c0, c1, d0, d1,
                                        sizeof(T) == 4);
        zq[hh * kQ + 2 * lane] = expf(total - c0) * d0;
        zq[hh * kQ + 2 * lane + 1] = expf(total - c1) * d1;
        if (lane == 0 && k.pb == 0)
            totals[(k.b * nc + k.c) * H + h] = total;
    }
    cp_async_wait_all();
    __syncthreads();

    for (int hh = 0; hh < k.nh; ++hh) {
        float* dst = states + slot(k.b, k.c, nc, k.h0 + hh, H, k.pb, npb, np);
        const T* xh = xs + hh * kQ * xs_;
        const float* z = zq + hh * kQ;
        if constexpr (sizeof(T) == 2) {
            // z⊙x split into bf16 high and low tiles [kQ][xs_]
            T* zh = reinterpret_cast<T*>(after_x);
            T* zl = zh + kQ * xs_;
            for (int i = threadIdx.x; i < kQ * kPB / 2; i += kThreads) {
                const int j = i / (kPB / 2), p = 2 * (i % (kPB / 2));
                const float zj = z[j];
                uint32_t hi, lo;
                split2(zj * to_f(xh[j * xs_ + p]),
                       zj * to_f(xh[j * xs_ + p + 1]), hi, lo);
                *reinterpret_cast<uint32_t*>(zh + j * xs_ + p) = hi;
                *reinterpret_cast<uint32_t*>(zl + j * xs_ + p) = lo;
            }
            __syncthreads();
            // S_loc [np][kPB] = Bᵀ (z⊙x): warp w takes row tiles w, w+8
            const int m = lane >> 3, r = lane & 7, g = lane >> 2,
                      t = lane & 3;
            for (int mt = warp; mt < np / 16; mt += kWarps) {
                float acc[8][4];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
                for (int kt = 0; kt < kQ / 16; ++kt) {
                    // A = Bᵀ rows 16mt.., k = j 16kt..: B is [j][n]
                    uint32_t a[4];
                    ldsm_x4_t(a, Bs + (16 * kt + 8 * (m >> 1) + r) * bcs +
                                     16 * mt + 8 * (m & 1));
#pragma unroll
                    for (int n2 = 0; n2 < 4; ++n2) {
                        const int off = (16 * kt + 8 * (m & 1) + r) * xs_ +
                                        8 * (2 * n2 + (m >> 1));
                        uint32_t bh[4], bl[4];
                        ldsm_x4_t(bh, zh + off);
                        ldsm_x4_t(bl, zl + off);
                        mma(acc[2 * n2], a, bh[0], bh[1]);
                        mma(acc[2 * n2], a, bl[0], bl[1]);
                        mma(acc[2 * n2 + 1], a, bh[2], bh[3]);
                        mma(acc[2 * n2 + 1], a, bl[2], bl[3]);
                    }
                }
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    const int n = 16 * mt + g, p = 8 * nt + 2 * t;
                    *reinterpret_cast<float2*>(dst + n * kPB + p) =
                        make_float2(acc[nt][0], acc[nt][1]);
                    *reinterpret_cast<float2*>(dst + (n + 8) * kPB + p) =
                        make_float2(acc[nt][2], acc[nt][3]);
                }
            }
            __syncthreads();   // the z⊙x tiles are the next head's
        } else {
            // S_loc[n][p] = Σ_j (B_jn z_j) x_jp, rows n = tn + 16 r and
            // columns 4 tj.. a thread, 8 rows a pass
            const int tn = threadIdx.x >> 4, tj = threadIdx.x & 15;
            for (int r0 = 0; r0 < np / 16; r0 += 8) {
                float acc[8][4];
#pragma unroll
                for (int r = 0; r < 8; ++r)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
                for (int j = 0; j < k.q_len; ++j) {
                    const float zj = z[j];
                    const float4 xv =
                        *reinterpret_cast<const float4*>(xh + j * xs_ + 4 * tj);
#pragma unroll
                    for (int r = 0; r < 8; ++r) {
                        const int n = tn + 16 * (r0 + r);
                        const float bz = (n < np ? Bs[j * bcs + n] : 0.0f) * zj;
                        acc[r][0] = fmaf(bz, xv.x, acc[r][0]);
                        acc[r][1] = fmaf(bz, xv.y, acc[r][1]);
                        acc[r][2] = fmaf(bz, xv.z, acc[r][2]);
                        acc[r][3] = fmaf(bz, xv.w, acc[r][3]);
                    }
                }
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    const int n = tn + 16 * (r0 + r);
                    if (n < np)
                        *reinterpret_cast<float4*>(dst + n * kPB + 4 * tj) =
                            make_float4(acc[r][0], acc[r][1], acc[r][2],
                                        acc[r][3]);
                }
            }
        }
    }
}

// ================================================== 2. the hand-off
// One thread a (b, h, P block, state row n, 4 columns).  The entering
// state of chunk c goes to `prev` at the chunk's slot: float32, or (bf16
// path) a high and a low bf16 plane of [np][kPB] each, the two in the
// bytes of the float32 block.  Padded rows and columns are written zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_handoff(const float* __restrict__ states,
                 const float* __restrict__ totals,
                 const float* __restrict__ init, void* __restrict__ prev,
                 float* __restrict__ fin, int Bsz, int nc, int H, int P,
                 int N) {
    const int np = round16(N), npb = (P + kPB - 1) / kPB;
    const long per_head = (long)npb * np * (kPB / 4);
    const long e = (long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= Bsz * H * per_head) return;
    const long b = e / (H * per_head);
    const int h = (int)((e / per_head) % H);
    const long rem = e % per_head;
    const int pb = (int)(rem / (np * (kPB / 4)));
    const int n = (int)((rem / (kPB / 4)) % np);
    const int q = 4 * (int)(rem % (kPB / 4));       // column in the block
    const int p = pb * kPB + q;
    const long in_slot = (long)n * kPB + q;
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        s[i] = (init != nullptr && n < N && p + i < P)
                   ? init[((b * H + h) * N + n) * (long)P + p + i]
                   : 0.0f;
    constexpr int U = 8;     // chunks whose loads are in flight together
    for (int c0 = 0; c0 < nc; c0 += U) {
        float4 loc[U];
        float et[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (c0 + u < nc) {
                loc[u] = *reinterpret_cast<const float4*>(
                    states + slot(b, c0 + u, nc, h, H, pb, npb, np) + in_slot);
                et[u] = expf(totals[(b * nc + c0 + u) * H + h]);
            }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (c0 + u >= nc) break;
            const long base = slot(b, c0 + u, nc, h, H, pb, npb, np);
            if constexpr (sizeof(T) == 2) {
                uint32_t hi[2], lo[2];
                split2(s[0], s[1], hi[0], lo[0]);
                split2(s[2], s[3], hi[1], lo[1]);
                // the block's bf16 planes start at 2·base (bf16 units)
                __nv_bfloat16* pl = reinterpret_cast<__nv_bfloat16*>(prev) +
                                    2 * base;
                *reinterpret_cast<uint2*>(pl + in_slot) =
                    make_uint2(hi[0], hi[1]);
                *reinterpret_cast<uint2*>(pl + (long)np * kPB + in_slot) =
                    make_uint2(lo[0], lo[1]);
            } else {
                *reinterpret_cast<float4*>(reinterpret_cast<float*>(prev) +
                                           base + in_slot) =
                    make_float4(s[0], s[1], s[2], s[3]);
            }
            s[0] = fmaf(s[0], et[u], loc[u].x);
            s[1] = fmaf(s[1], et[u], loc[u].y);
            s[2] = fmaf(s[2], et[u], loc[u].z);
            s[3] = fmaf(s[3], et[u], loc[u].w);
        }
    }
    if (n < N)
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (p + i < P) fin[((b * H + h) * N + n) * (long)P + p + i] = s[i];
}

// ===================================================== 3. the output
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_output(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const void* __restrict__ prev,
                int has_init, T* __restrict__ y, int L, int H, int P, int N,
                int heads, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout<T> lay(N, heads);
    const int np = lay.np, bcs = lay.bc_stride();
    constexpr int xs_ = Layout<T>::x_stride();
    T* Cs = reinterpret_cast<T*>(smem);                        // [kQ][bcs]
    unsigned char* region = smem + lay.bc_bytes();             // B, then S
    T* Bs = reinterpret_cast<T*>(region);                      // [kQ][bcs]
    T* Ss = reinterpret_cast<T*>(region);                      // [np][xs_] (x2)
    T* xs = reinterpret_cast<T*>(region + lay.region_bytes()); // [nh][kQ][xs_]
    float* Ws = reinterpret_cast<float*>(
        region + lay.region_bytes() + heads * lay.x_bytes());  // [kQ][kQ+1]
    float* cum = reinterpret_cast<float*>(
        reinterpret_cast<unsigned char*>(Ws) + lay.w_bytes()); // [nh][kQ]
    float* dts = cum + heads * kQ;                             // [nh][kQ]
    const Cta k(L, H, P, heads);
    const int nc = (L + kQ - 1) / kQ, npb = (P + kPB - 1) / kPB;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // the entering state is zero in chunk 0 without an initial state
    const bool inter = k.c > 0 || has_init;

    const long row0 = k.b * L + k.t0;
    load_tile(Cs, bcs, Cm + row0 * N, N, kQ, np, k.q_len, N, vec);
    load_tile(Bs, bcs, Bm + row0 * N, N, kQ, np, k.q_len, N, vec);
    for (int hh = 0; hh < k.nh; ++hh)
        load_tile(xs + hh * kQ * xs_, xs_,
                  x + (row0 * H + k.h0 + hh) * (long)P + k.p0, (long)H * P,
                  kQ, kPB, k.q_len, k.p_ok, vec);
    cp_async_commit();
    for (int hh = warp; hh < k.nh; hh += kWarps) {
        const int h = k.h0 + hh;
        float c0, c1, d0, d1;
        warp_cumsum(dt, row0 * H + h, H, k.q_len, A[h], c0, c1, d0, d1,
                    sizeof(T) == 4);
        cum[hh * kQ + 2 * lane] = c0;
        cum[hh * kQ + 2 * lane + 1] = c1;
        dts[hh * kQ + 2 * lane] = d0;
        dts[hh * kQ + 2 * lane + 1] = d1;
    }
    cp_async_wait_all();
    __syncthreads();

    // the entering state of head hh: cp.async into the region (B's, once
    // C Bᵀ is formed); the caller commits
    auto load_state = [&](int hh) {
        const long base = slot(k.b, k.c, nc, k.h0 + hh, H, k.pb, npb, np);
        const T* src = reinterpret_cast<const T*>(prev) +
                       (sizeof(T) == 2 ? 2 * base : base);
        const int planes = sizeof(T) == 2 ? 2 : 1;
        for (int pl = 0; pl < planes; ++pl)
            load_tile(Ss + pl * np * xs_, xs_, src + (long)pl * np * kPB,
                      (long)kPB, np, kPB, np, kPB, true);
    };

    if constexpr (sizeof(T) == 2) {
        // warp w: rows 16 rt.. of the chunk, columns 32 ch.. of the block
        const int rt = warp & 3, ch = warp >> 2;
        const int m = lane >> 3, r = lane & 7, g = lane >> 2, t = lane & 3;
        // C Bᵀ, rows 16rt.., columns j < 16 (rt + 1) (8 j a tile)
        float cb[8][4];
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
#pragma unroll
            for (int e = 0; e < 4; ++e) cb[jt][e] = 0.0f;
        for (int kk = 0; kk < np / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, Cs + (16 * rt + (lane & 15)) * bcs + 16 * kk +
                           8 * (lane >> 4));
#pragma unroll
            for (int j2 = 0; j2 < 4; ++j2)
                if (j2 <= rt) {
                    uint32_t bb[4];
                    ldsm_x4(bb, Bs + (16 * j2 + 8 * (m >> 1) + r) * bcs +
                                    16 * kk + 8 * (m & 1));
                    mma(cb[2 * j2], a, bb[0], bb[1]);
                    mma(cb[2 * j2 + 1], a, bb[2], bb[3]);
                }
        }
        __syncthreads();   // B is dead: the region takes the state
        const int i0 = 16 * rt + g, i1 = i0 + 8;
        if (inter) {
            load_state(0);
            cp_async_commit();
        }
        for (int hh = 0; hh < k.nh; ++hh) {
            const int h = k.h0 + hh;
            const float* ch_ = cum + hh * kQ;
            const float* dh = dts + hh * kQ;
            const T* xh = xs + hh * kQ * xs_;
            const float ci0 = ch_[i0], ci1 = ch_[i1];
            // y_intra = W x; W's A fragments from C Bᵀ's accumulators
            float yi[4][4], yo[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) yi[nt][e] = yo[nt][e] = 0.0f;
#pragma unroll
            for (int kt = 0; kt < 4; ++kt)
                if (kt <= rt) {
                    float w[8];
#pragma unroll
                    for (int half = 0; half < 2; ++half)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int i = e < 2 ? i0 : i1;
                            const int j = 16 * kt + 8 * half + 2 * t + (e & 1);
                            const float ci = e < 2 ? ci0 : ci1;
                            w[4 * half + e] =
                                j <= i ? cb[2 * kt + half][e] *
                                             expf(ci - ch_[j]) * dh[j]
                                       : 0.0f;
                        }
                    uint32_t wh[4], wl[4];
                    split2(w[0], w[1], wh[0], wl[0]);   // row i0, j 2t..
                    split2(w[2], w[3], wh[1], wl[1]);   // row i1
                    split2(w[4], w[5], wh[2], wl[2]);   // row i0, j 8+2t..
                    split2(w[6], w[7], wh[3], wl[3]);   // row i1
#pragma unroll
                    for (int n2 = 0; n2 < 2; ++n2) {
                        uint32_t xb[4];
                        ldsm_x4_t(xb, xh + (16 * kt + 8 * (m & 1) + r) * xs_ +
                                          32 * ch + 8 * (2 * n2 + (m >> 1)));
                        mma(yi[2 * n2], wh, xb[0], xb[1]);
                        mma(yi[2 * n2], wl, xb[0], xb[1]);
                        mma(yi[2 * n2 + 1], wh, xb[2], xb[3]);
                        mma(yi[2 * n2 + 1], wl, xb[2], xb[3]);
                    }
                }
            if (inter) {
                // y_inter = C S_in, S_in in high and low planes [np][xs_]
                cp_async_wait_all();
                __syncthreads();
                const T* Sh = Ss;
                const T* Sl = Ss + np * xs_;
                for (int kk = 0; kk < np / 16; ++kk) {
                    uint32_t a[4];
                    ldsm_x4(a, Cs + (16 * rt + (lane & 15)) * bcs + 16 * kk +
                                   8 * (lane >> 4));
#pragma unroll
                    for (int n2 = 0; n2 < 2; ++n2) {
                        const int off = (16 * kk + 8 * (m & 1) + r) * xs_ +
                                        32 * ch + 8 * (2 * n2 + (m >> 1));
                        uint32_t sh[4], sl[4];
                        ldsm_x4_t(sh, Sh + off);
                        ldsm_x4_t(sl, Sl + off);
                        mma(yo[2 * n2], a, sh[0], sh[1]);
                        mma(yo[2 * n2], a, sl[0], sl[1]);
                        mma(yo[2 * n2 + 1], a, sh[2], sh[3]);
                        mma(yo[2 * n2 + 1], a, sl[2], sl[3]);
                    }
                }
                __syncthreads();   // every warp is done with this state
                if (hh + 1 < k.nh) {
                    load_state(hh + 1);
                    cp_async_commit();
                }
            }
            const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int p = 32 * ch + 8 * nt + 2 * t;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int i = half ? i1 : i0;
                    const float e = half ? e1 : e0;
                    if (i >= k.q_len) continue;
                    const float v0 = yi[nt][2 * half] + yo[nt][2 * half] * e;
                    const float v1 =
                        yi[nt][2 * half + 1] + yo[nt][2 * half + 1] * e;
                    T* dst = y + ((row0 + i) * H + h) * (long)P + k.p0 + p;
                    if (vec) {
                        if (p < k.p_ok)
                            *reinterpret_cast<__nv_bfloat162*>(dst) =
                                __floats2bfloat162_rn(v0, v1);
                    } else {
                        if (p < k.p_ok) dst[0] = from_f<T>(v0);
                        if (p + 1 < k.p_ok) dst[1] = from_f<T>(v1);
                    }
                }
            }
        }
    } else {
        // thread (ti, tj): C Bᵀ entries (ti + 16 r, tj + 16 c); y rows
        // ti + 16 r, columns 4 tj..
        const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
        float cb[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) cb[a][c] = 0.0f;
        for (int n = 0; n < np; n += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                cv[q] = *reinterpret_cast<const float4*>(
                    Cs + (ti + 16 * q) * bcs + n);
                bv[q] = *reinterpret_cast<const float4*>(
                    Bs + (tj + 16 * q) * bcs + n);
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    cb[a][c] = fmaf(cv[a].x, bv[c].x, cb[a][c]);
                    cb[a][c] = fmaf(cv[a].y, bv[c].y, cb[a][c]);
                    cb[a][c] = fmaf(cv[a].z, bv[c].z, cb[a][c]);
                    cb[a][c] = fmaf(cv[a].w, bv[c].w, cb[a][c]);
                }
        }
        __syncthreads();   // B is dead: the region takes the state
        for (int hh = 0; hh < k.nh; ++hh) {
            const int h = k.h0 + hh;
            const float* ch_ = cum + hh * kQ;
            const float* dh = dts + hh * kQ;
            const float* xh = reinterpret_cast<const float*>(xs) +
                              hh * kQ * xs_;
            if (inter) {
                load_state(hh);
                cp_async_commit();
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int i = ti + 16 * a, j = tj + 16 * c;
                    Ws[i * (kQ + 1) + j] =
                        j <= i ? cb[a][c] * expf(ch_[i] - ch_[j]) * dh[j]
                               : 0.0f;
                }
            __syncthreads();
            float yi[4][4], yo[4][4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int e = 0; e < 4; ++e) yi[a][e] = yo[a][e] = 0.0f;
            for (int j = 0; j < kQ; ++j) {
                const float4 xv =
                    *reinterpret_cast<const float4*>(xh + j * xs_ + 4 * tj);
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const float w = Ws[(ti + 16 * a) * (kQ + 1) + j];
                    yi[a][0] = fmaf(w, xv.x, yi[a][0]);
                    yi[a][1] = fmaf(w, xv.y, yi[a][1]);
                    yi[a][2] = fmaf(w, xv.z, yi[a][2]);
                    yi[a][3] = fmaf(w, xv.w, yi[a][3]);
                }
            }
            if (inter) {
                cp_async_wait_all();
                __syncthreads();
                const float* Sf = reinterpret_cast<const float*>(Ss);
                for (int n = 0; n < np; ++n) {
                    const float4 sv =
                        *reinterpret_cast<const float4*>(Sf + n * xs_ + 4 * tj);
#pragma unroll
                    for (int a = 0; a < 4; ++a) {
                        const float cv = Cs[(ti + 16 * a) * bcs + n];
                        yo[a][0] = fmaf(cv, sv.x, yo[a][0]);
                        yo[a][1] = fmaf(cv, sv.y, yo[a][1]);
                        yo[a][2] = fmaf(cv, sv.z, yo[a][2]);
                        yo[a][3] = fmaf(cv, sv.w, yo[a][3]);
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int i = ti + 16 * a;
                if (i >= k.q_len) continue;
                const float e = expf(ch_[i]);
                T* dst = y + ((row0 + i) * H + h) * (long)P + k.p0 + 4 * tj;
                float v[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) v[q] = yi[a][q] + yo[a][q] * e;
                if (vec) {
                    if (4 * tj < k.p_ok)
                        *reinterpret_cast<float4*>(dst) =
                            make_float4(v[0], v[1], v[2], v[3]);
                } else {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (4 * tj + q < k.p_ok) dst[q] = from_f<T>(v[q]);
                }
            }
            __syncthreads();   // W and the state region are the next head's
        }
    }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* init,
                     void* y, void* fin, void* states, void* prev,
                     void* totals, int B, int L, int H, int P, int N,
                     int heads, cudaStream_t stream) {
    const Layout<T> lay(N, heads);
    const size_t s_smem = lay.states_bytes(), o_smem = lay.output_bytes();
    if (s_smem > (size_t)kSmemLimit || o_smem > (size_t)kSmemLimit)
        return cudaErrorInvalidValue;
    const int nc = (L + kQ - 1) / kQ, npb = (P + kPB - 1) / kPB;
    const int groups = (H + heads - 1) / heads;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(Bm) |
                           reinterpret_cast<uintptr_t>(Cm) |
                           reinterpret_cast<uintptr_t>(y);
    const int vec = (bits % 16 == 0) && P % 8 == 0 && N % 8 == 0;
    const dim3 grid(nc, groups * npb, B);
    cudaError_t err;
    if (nc > 0) {
        err = cudaFuncSetAttribute(ssd_scan_states<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)s_smem);
        if (err != cudaSuccess) return err;
        ssd_scan_states<T><<<grid, kThreads, s_smem, stream>>>(
            static_cast<const T*>(x), static_cast<const float*>(dt),
            static_cast<const float*>(A), static_cast<const T*>(Bm),
            static_cast<float*>(states), static_cast<float*>(totals), L, H,
            P, N, heads, vec);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    const long threads = (long)B * H * npb * round16(N) * (kPB / 4);
    ssd_scan_handoff<T><<<(unsigned)((threads + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
        static_cast<const float*>(states), static_cast<const float*>(totals),
        static_cast<const float*>(init), prev, static_cast<float*>(fin), B,
        nc, H, P, N);
    err = cudaGetLastError();
    if (err != cudaSuccess || nc == 0) return err;
    err = cudaFuncSetAttribute(ssd_scan_output<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)o_smem);
    if (err != cudaSuccess) return err;
    ssd_scan_output<T><<<grid, kThreads, o_smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), prev, init != nullptr,
        static_cast<T*>(y), L, H, P, N, heads, vec);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of ssd_scan_states (kernel 0) or
// ssd_scan_output (kernel 1) at state size N and `heads` heads a CTA.
int ssd_scan_smem(int bf16, int N, int heads, int kernel) {
    if (bf16) {
        const Layout<__nv_bfloat16> lay(N, heads);
        return (int)(kernel ? lay.output_bytes() : lay.states_bytes());
    }
    const Layout<float> lay(N, heads);
    return (int)(kernel ? lay.output_bytes() : lay.states_bytes());
}

// x [B, L, H, P], B/C [B, L, N] and y [B, L, H, P] contiguous, bfloat16
// when bf16 != 0 else float32; dt [B, L, H], A [H], init (or null) and
// fin [B, H, N, P] contiguous float32.  states and prev: float32 scratch
// of B·nc·H·npb·np·64 each (nc = ceil(L / 64), npb = ceil(P / 64),
// np = N rounded up to 16), 16-byte aligned; totals: B·nc·H float32.
// N <= 256, 1 <= heads <= 4.  Three launches on `stream` (the hand-off
// alone at L = 0); returns the first CUDA error (0 on success).
int ssd_scan_chunks_launch(int bf16, const void* x, const void* dt,
                           const void* A, const void* Bm, const void* Cm,
                           const void* init, void* y, void* fin,
                           void* states, void* prev, void* totals, int B,
                           int L, int H, int P, int N, int heads,
                           void* stream) {
    if (B == 0 || H == 0 || P == 0) return 0;
    if (N <= 0 || N > 256 || heads < 1 || heads > kMaxHeads || L < 0)
        return (int)cudaErrorInvalidValue;
    if (bf16)
        return (int)launch_t<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, fin,
                                            states, prev, totals, B, L, H, P,
                                            N, heads, (cudaStream_t)stream);
    return (int)launch_t<float>(x, dt, A, Bm, Cm, init, y, fin, states, prev,
                                totals, B, L, H, P, N, heads,
                                (cudaStream_t)stream);
}

}  // extern "C"
