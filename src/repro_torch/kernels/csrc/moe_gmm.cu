// Grouped (per-expert) matrix product of the MoE FFN:
//   out[e] = x[e] @ w[e],   x [E, C, D], w [E, D, F] -> out [E, C, F],
// and out[e] = 0 for an expert that `active` marks empty.
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
// GFLOP at the decode step's C = 4.  So the design aims at one pass over
// w at the HBM rate:
//
// * A persistent grid, two or three CTAs an SM.  The tiles are (expert,
//   128 rows of C, 64 or 128 columns of F) of the ACTIVE experts, in
//   that order; CTA b
//   of G takes the tiles b, b + G, b + 2G, ..., so every CTA has the
//   same number of tiles to within one, the last wave is as full as the
//   first, and the CTAs side by side read whole rows of one expert's w
//   (and its x blocks once from L2 for all its column blocks).  Each
//   output element is summed by one CTA, over D in ascending blocks: no
//   split of D, no atomics, the same bits on every run.
//   kernels/moe_gmm.py:tile_schedule is the same schedule in Python.
// * Empty experts are skipped on the device.  `active` ([E], bool or
//   int32, or none) is read by each CTA into a list of the active
//   experts (then the inactive ones); the inactive experts' outputs are
//   zeroed and none of their weight is read.  No host sync, so the
//   launch can be captured in a CUDA graph.  In a decode step (8 tokens,
//   top-8 of 64) about 40 experts hold a row.
// * One stream of tiles a CTA: the x and w tiles of consecutive
//   (tile, depth block) steps flow through a ring of 3 to 8 shared
//   buffers (as deep as the CTAs an SM allow) filled by cp.async (16
//   bytes a thread, zero-filled past C and D) across tile boundaries, so
//   all but one block of the ring are in flight while one is
//   multiplied.
//
// Two kernels on that schedule, picked by what the launch can observe:
//
// * bfloat16 with D and F multiples of 8 and 16-byte aligned pointers:
//   tensor cores.  One warpgroup a CTA runs wgmma m64n64k16 on x and w
//   straight from shared memory (bf16 in, f32 accumulate; the products
//   of two bf16 are exact in f32, so this is the float32 sum of the
//   Pallas kernel in another order), x padded to 64 (C <= 64) or 128
//   rows with zero rows that are written once, so the padding costs no
//   bytes from HBM and no shared-memory traffic a step.
// * float32, or bfloat16 that is not so aligned: CUDA cores with float32
//   FMAs (TF32 would not keep the float32 sums of the reference).  256
//   threads; thread (ty, tx) of a 16 x 16 grid sums rows ty + 16i and
//   columns 4tx..4tx+3, four depths at a time from float4 loads of the
//   staged tiles.  Aligned float32 stages through the cp.async ring; the
//   rest (off the MoE path) stages with plain loads into the same ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 128;        // rows of x a tile holds
constexpr int kBN = 64;           // columns of F a CUDA-core tile computes
constexpr int kCtasPerSm = 2;     // CTAs of the CUDA-core grid an SM
constexpr unsigned kFull = 0xffffffffu;

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

// ------------------------------------------------------- the schedule
__device__ __forceinline__ bool is_active(const void* active, int bytes,
                                          int e) {
    if (bytes == 1) return static_cast<const uint8_t*>(active)[e] != 0;
    if (bytes == 4) return static_cast<const int*>(active)[e] != 0;
    return true;
}

// list[0, n) = the active experts ascending, list[n, E) the others,
// list[E] = n; returns n.  Warp 0 compacts by ballots, 32 at a time.
__device__ int expert_list(const void* active, int bytes, int E,
                           int* list) {
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        const unsigned below = (1u << lane) - 1u;
        int n = 0;
        for (int pass = 0; pass < 2; ++pass) {
            for (int e0 = 0; e0 < E; e0 += 32) {
                const int e = e0 + lane;
                const bool on = e < E
                    && is_active(active, bytes, e) == (pass == 0);
                const unsigned m = __ballot_sync(kFull, on);
                if (on) list[n + __popc(m & below)] = e;
                n += __popc(m);
            }
            if (pass == 0 && lane == 0) list[E] = n;
        }
    }
    __syncthreads();
    return list[E];
}

// zero the outputs of the inactive experts list[n_act, E), over the grid
template <typename T>
__device__ void zero_inactive(T* o, const int* list, int n_act, int E,
                              int C, int F) {
    const long per = (long)C * F;
    const long total = (long)(E - n_act) * per;
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (long)gridDim.x * blockDim.x) {
        const long k = i / per;
        o[(long)list[n_act + k] * per + (i - k * per)] = from_f<T>(0.0f);
    }
}

// the tiles (128 rows x bn columns) of CTA b of G: b, b + G, b + 2G, ...
// of the NT = n_act·per_e tiles of the active experts, expert-major,
// then m-block, then n-block.
// At any time the grid works on about G consecutive tiles: the 16
// column blocks of an expert side by side (whole rows of w, one pass
// over each x block from L2), and no CTA has more than one tile over
// another.
struct Tiles {
    int count, bn, nnb, per_e;
    __device__ Tiles(int n_act, int C, int F, int bn_) : bn(bn_) {
        nnb = (F + bn - 1) / bn;
        per_e = nnb * ((C + kMaxM - 1) / kMaxM);
        const int nt = n_act * per_e;
        count = nt > (int)blockIdx.x
            ? (nt - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
            : 0;
    }
    // this CTA's j-th tile -> expert, first row, first column
    __device__ void at(int j, const int* list, int& e, int& r0,
                       int& n0) const {
        const int t = (int)blockIdx.x + j * (int)gridDim.x;
        const int k = t / per_e, rem = t - k * per_e;
        e = list[k];
        r0 = (rem / nnb) * kMaxM;
        n0 = (rem % nnb) * bn;
    }
};

// 16 bytes global -> shared address `dst`, asynchronous; zero-filled
// when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ------------------------------------------------- tensor-core kernel
// One warpgroup a CTA.  Each step multiplies the staged x block (64 or
// 128 rows x 64 depths, K-major) by the staged w block (64 depths x 64
// or 128 columns, MN-major) with four wgmma m64nNk16 a 64 rows, both
// operands read from shared memory in the 128-byte swizzle (the
// descriptors and the swizzled cp.async stores of
// csrc/flash_attention.cu); the x rows past C are zero rows that no load
// touches.  Tiles are 64 columns wide at C <= 16 (the decode: finer
// tiles balance the active experts over the grid) and 128 wide above
// (the prefill: each x block is read from L2 half as often).
constexpr int kWgThreads = 128;
constexpr int kBD = 64;                  // depth of one staged block
constexpr int kBlockBytes = 64 * 128;    // 64 rows x 128 bytes
// CTAs an SM and ring depth at mb 64-row blocks and nb 64-column blocks:
// three CTAs at the decode's 64 x 64 tiles (more CTAs keep the active
// experts' tiles spread), two above; the rings fill the 228 KB an SM has
__host__ __device__ constexpr int wg_ctas_per_sm(int mb, int nb) {
    return mb + nb == 2 ? 3 : 2;
}
__host__ __device__ constexpr int wg_stages(int mb, int nb) {
    return mb + nb == 2 ? 4 : mb + nb == 3 ? 4 : 3;
}

size_t wg_smem_bytes(int mb, int nb, int E) {
    return (size_t)wg_stages(mb, nb) * (mb + nb) * kBlockBytes + 1024
        + sizeof(int) * (E + 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// K-major (x): 8-row groups 1024 bytes apart (stride), the leading
// offset unused.  MN-major (w): 64-column blocks `lbo` apart (leading),
// 8-row groups 1024 bytes apart (stride).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
        | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// d[0..31] (+)= A·B for one m64n64k16 step, A K-major and B MN-major,
// both from shared memory; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 1;\n}\n"
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

// d[0..63] (+)= A·B for one m64n128k16 step, as wgmma_n64
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 1;\n}\n"
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
        : "l"(da), "l"(db), "r"(scale_d));
}

// stage depth block kb of tile (e, r0, n0): x rows [r0, r0 + x_rows)
// and w columns [n0, n0 + 64·NB), 128 bytes a row of each 64-column
// block with 16-byte chunk c of row r at chunk c ^ (r % 8) (the
// 128-byte swizzle wgmma reads)
template <int NB>
__device__ __forceinline__ void wg_stage(
        uint32_t sX, uint32_t sW, const __nv_bfloat16* x,
        const __nv_bfloat16* w, int e, int r0, int n0, int kb, int C,
        int D, int F, int x_rows) {
    const int rows = min(kMaxM, C - r0), d0 = kb * kBD;
    const __nv_bfloat16* xe = x + ((long)e * C + r0) * D;
    const __nv_bfloat16* we = w + (long)e * D * F;
    for (int idx = threadIdx.x; idx < x_rows * 8; idx += kWgThreads) {
        const int r = idx >> 3, c = idx & 7, d = d0 + c * 8;
        const bool ok = r < rows && d < D;
        cp_async16(sX + r * 128 + ((c ^ (r & 7)) << 4),
                   ok ? xe + (long)r * D + d : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kBD * 8 * NB / kWgThreads; ++i) {
        const int idx = threadIdx.x + i * kWgThreads;
        const int k = idx / (8 * NB), c = idx % (8 * NB);
        const int d = d0 + k, n = n0 + c * 8;
        const bool ok = d < D && n < F;
        cp_async16(sW + (c >> 3) * kBlockBytes + k * 128
                       + (((c & 7) ^ (k & 7)) << 4),
                   ok ? we + (long)d * F + n : w, ok);
    }
}

template <int MB, int NB>
__global__ void __launch_bounds__(kWgThreads)
gmm_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ o, const void* active,
                 int act_bytes, int E, int C, int D, int F) {
    constexpr int kStages = wg_stages(MB, NB);
    constexpr int kStage = (MB + NB) * kBlockBytes;  // x blocks, then w
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the ring, 1024-byte aligned (the swizzle's period), then the list
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* ring = smem_raw + (base - raw);
    int* list = reinterpret_cast<int*>(ring + kStages * kStage);
    const int n_act = expert_list(active, act_bytes, E, list);
    zero_inactive(o, list, n_act, E, C, F);
    const Tiles tiles(n_act, C, F, 64 * NB);
    const int nk = (D + kBD - 1) / kBD;
    const int steps = tiles.count * nk;
    // rows staged a block (C rounded up to 8); the rest stay zero
    const int x_rows = min(MB * 64, (min(C, kMaxM) + 7) & ~7);
    {
        const int zr = (MB * 64 - x_rows) * 8;      // zero chunks a stage
        for (int idx = threadIdx.x; idx < kStages * zr;
             idx += kWgThreads) {
            const int s = idx / zr, rem = idx - s * zr;
            *reinterpret_cast<uint4*>(ring + s * kStage + x_rows * 128
                                      + rem * 16) = make_uint4(0, 0, 0, 0);
        }
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;   // fragment row group, thread
    float acc[MB][32 * NB];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int j = 0; j < 32 * NB; ++j) acc[mb][j] = 0.0f;

    // the load cursor runs kStages - 1 steps ahead of the compute one
    int lt = 0, lkb = 0, le = 0, lr0 = 0, ln0 = 0;
    if (steps > 0) tiles.at(lt, list, le, lr0, ln0);
    auto load_next = [&](int slot) {
        const uint32_t sX = base + slot * kStage;
        wg_stage<NB>(sX, sX + MB * kBlockBytes, x, w, le, lr0, ln0, lkb, C,
                     D, F, x_rows);
        if (++lkb == nk) {
            lkb = 0;
            if (++lt < tiles.count) tiles.at(lt, list, le, lr0, ln0);
        }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < steps) load_next(s);
        cp_async_commit();
    }
    int ct = 0, ckb = 0;
    for (int i = 0; i < steps; ++i) {
        cp_async_wait<kStages - 2>();   // step i has landed (this thread)
        fence_proxy_async();
        __syncthreads();                // ... for every thread; step i-1
                                        // is consumed (its wgmma waited)
        if (i + kStages - 1 < steps) load_next((i + kStages - 1) % kStages);
        cp_async_commit();
        const uint32_t sX = base + (i % kStages) * kStage;
        const uint32_t sW = sX + MB * kBlockBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBD / 16; ++kk) {
            const uint64_t db = sw128_desc(sW + kk * 2048, kBlockBytes, 1024);
#pragma unroll
            for (int mb = 0; mb < MB; ++mb) {
                const uint64_t da = sw128_desc(sX + mb * kBlockBytes
                                               + kk * 32, 16, 1024);
                if constexpr (NB == 1)
                    wgmma_n64(acc[mb], da, db, ckb > 0 || kk > 0);
                else
                    wgmma_n128(acc[mb], da, db, ckb > 0 || kk > 0);
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
        if (++ckb == nk) {              // the tile is summed: store it
            int e, r0, n0;
            tiles.at(ct, list, e, r0, n0);
            const int rows = min(kMaxM, C - r0);
            __nv_bfloat16* oe = o + ((long)e * C + r0) * F;
            // acc[mb][4j + q]: row 64mb + 16warp + g (+ 8 for q >= 2),
            // column n0 + 8j + 2t (+ 1 for odd q)
#pragma unroll
            for (int mb = 0; mb < MB; ++mb) {
                const int ra = mb * 64 + warp * 16 + g, rb = ra + 8;
#pragma unroll
                for (int j = 0; j < 8 * NB; ++j) {
                    const int col = n0 + 8 * j + 2 * t;
                    if (col >= F) continue;     // F % 8 == 0: col + 1 < F
                    if (ra < rows)
                        *reinterpret_cast<__nv_bfloat162*>(
                            oe + (long)ra * F + col) =
                            __floats2bfloat162_rn(acc[mb][4 * j],
                                                  acc[mb][4 * j + 1]);
                    if (rb < rows)
                        *reinterpret_cast<__nv_bfloat162*>(
                            oe + (long)rb * F + col) =
                            __floats2bfloat162_rn(acc[mb][4 * j + 2],
                                                  acc[mb][4 * j + 3]);
                }
            }
            ckb = 0;
            ++ct;
        }
    }
    cp_async_wait<0>();
}

// ----------------------------------------------------- CUDA-core kernel
constexpr int kSimtThreads = 256; // 16 row groups x 16 column groups
constexpr int kSD = 32;           // depth of one staged block
__host__ __device__ constexpr int simt_stages(int rt) {
    return rt <= 2 ? 8 : 4;       // two CTAs an SM at every C
}
constexpr int kLdXs = kSD + 4;    // float row pitch of the x tile (144 B)

size_t simt_smem_bytes(int rt, int E) {
    return sizeof(float) * simt_stages(rt)
        * ((size_t)rt * 16 * kLdXs + (size_t)kSD * kBN)
        + sizeof(int) * (E + 1);
}

// stage depth block kb of tile (e, r0, n0) as float32: by cp.async when
// kVec (float32, D and F multiples of 4, 16-byte aligned), else by plain
// loads and stores
template <typename T, int kRows, bool kVec>
__device__ __forceinline__ void simt_stage(
        float* Xs, float* Ws, const T* x, const T* w, int e, int r0,
        int n0, int kb, int C, int D, int F) {
    const int rows = min(kMaxM, C - r0), d0 = kb * kSD;
    const T* xe = x + ((long)e * C + r0) * D;
    const T* we = w + (long)e * D * F;
    if constexpr (kVec) {
        constexpr int kChunks = kSD / 4;
        for (int idx = threadIdx.x; idx < kRows * kChunks;
             idx += kSimtThreads) {
            const int r = idx / kChunks, c = idx - r * kChunks;
            const int d = d0 + c * 4;
            const bool ok = r < rows && d < D;
            cp_async16(smem_u32(Xs + r * kLdXs + c * 4),
                       ok ? xe + (long)r * D + d : x, ok);
        }
        constexpr int kWChunks = kBN / 4;
        for (int idx = threadIdx.x; idx < kSD * kWChunks;
             idx += kSimtThreads) {
            const int k = idx / kWChunks, c = idx - k * kWChunks;
            const int d = d0 + k, n = n0 + c * 4;
            const bool ok = d < D && n < F;
            cp_async16(smem_u32(Ws + k * kBN + c * 4),
                       ok ? we + (long)d * F + n : w, ok);
        }
    } else {
        for (int idx = threadIdx.x; idx < kRows * kSD;
             idx += kSimtThreads) {
            const int r = idx / kSD, k = idx - r * kSD, d = d0 + k;
            Xs[r * kLdXs + k] = (r < rows && d < D)
                ? to_f(xe[(long)r * D + d]) : 0.0f;
        }
        for (int idx = threadIdx.x; idx < kSD * kBN; idx += kSimtThreads) {
            const int k = idx / kBN, n = idx - k * kBN;
            const int d = d0 + k, col = n0 + n;
            Ws[k * kBN + n] = (d < D && col < F)
                ? to_f(we[(long)d * F + col]) : 0.0f;
        }
    }
}

template <typename T, int RT, bool kVec>
__global__ void __launch_bounds__(kSimtThreads, 1)
gmm_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ o, const void* active, int act_bytes,
                int E, int C, int D, int F) {
    constexpr int kRows = RT * 16, kSStages = simt_stages(RT);
    constexpr int kXStage = kRows * kLdXs, kWStage = kSD * kBN;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Xs = reinterpret_cast<float*>(smem_raw);
    float* Ws = Xs + kSStages * kXStage;
    int* list = reinterpret_cast<int*>(Ws + kSStages * kWStage);
    const int n_act = expert_list(active, act_bytes, E, list);
    zero_inactive(o, list, n_act, E, C, F);
    const Tiles tiles(n_act, C, F, kBN);
    const int nk = (D + kSD - 1) / kSD;
    const int steps = tiles.count * nk;

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    // a warp holds row groups 2w and 2w+1: it skips the products when
    // no tile of this launch has a row there (C <= 16 at the decode)
    const bool live = 2 * (threadIdx.x >> 5) < min(C, kRows);
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

    int lt = 0, lkb = 0, le = 0, lr0 = 0, ln0 = 0;
    if (steps > 0) tiles.at(lt, list, le, lr0, ln0);
    auto load_next = [&](int slot) {
        simt_stage<T, kRows, kVec>(Xs + slot * kXStage, Ws + slot * kWStage,
                                   x, w, le, lr0, ln0, lkb, C, D, F);
        if (++lkb == nk) {
            lkb = 0;
            if (++lt < tiles.count) tiles.at(lt, list, le, lr0, ln0);
        }
    };
#pragma unroll
    for (int s = 0; s < kSStages - 1; ++s) {
        if (s < steps) load_next(s);
        cp_async_commit();
    }
    int ct = 0, ckb = 0;
    for (int i = 0; i < steps; ++i) {
        cp_async_wait<kSStages - 2>();
        __syncthreads();
        if (i + kSStages - 1 < steps)
            load_next((i + kSStages - 1) % kSStages);
        cp_async_commit();
        const int s = i % kSStages;
        const float* xs = Xs + s * kXStage + ty * kLdXs;
        const float* ws = Ws + s * kWStage + tx * 4;
        if (live) {
#pragma unroll
            for (int k4 = 0; k4 < kSD; k4 += 4) {
                float4 xv[RT];
#pragma unroll
                for (int i2 = 0; i2 < RT; ++i2)
                    xv[i2] = *reinterpret_cast<const float4*>(
                        xs + i2 * 16 * kLdXs + k4);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const float4 wv = *reinterpret_cast<const float4*>(
                        ws + (k4 + kk) * kBN);
#pragma unroll
                    for (int i2 = 0; i2 < RT; ++i2) {
                        const float xk = kk == 0 ? xv[i2].x
                                       : kk == 1 ? xv[i2].y
                                       : kk == 2 ? xv[i2].z : xv[i2].w;
                        acc[i2][0] = fmaf(xk, wv.x, acc[i2][0]);
                        acc[i2][1] = fmaf(xk, wv.y, acc[i2][1]);
                        acc[i2][2] = fmaf(xk, wv.z, acc[i2][2]);
                        acc[i2][3] = fmaf(xk, wv.w, acc[i2][3]);
                    }
                }
            }
        }
        if (++ckb == nk) {
            int e, r0, n0;
            tiles.at(ct, list, e, r0, n0);
            const int rows = min(kMaxM, C - r0);
            T* oe = o + ((long)e * C + r0) * F;
#pragma unroll
            for (int i2 = 0; i2 < RT; ++i2) {
                const int r = ty + 16 * i2;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int col = n0 + tx * 4 + j;
                    if (r < rows && col < F)
                        oe[(long)r * F + col] = from_f<T>(acc[i2][j]);
                    acc[i2][j] = 0.0f;
                }
            }
            ckb = 0;
            ++ct;
        }
    }
    cp_async_wait<0>();
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
                || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                          dev) != cudaSuccess)
            sms = 0;
    }
    return sms;
}

}  // namespace

extern "C" {

// x [E, C, D], w [E, D, F] and out [E, C, F], all contiguous, one type:
// bf16 != 0 bfloat16, else float32.  `active` is [E] bool (act_bytes 1)
// or int32 (4), or null (act_bytes 0: every expert).  bfloat16 with D
// and F multiples of 8 and 16-byte aligned pointers goes to the
// tensor-core kernel, the rest to the CUDA-core one.  The grid is two
// or three CTAs an SM (fewer when there are fewer tiles).  Returns
// cudaGetLastError() of the launch.
int moe_gmm_launch(int bf16, const void* x, const void* w, void* out,
                   const void* active, int act_bytes, int E, int C, int D,
                   int F, void* stream) {
    if (E == 0 || C == 0 || F == 0) return 0;
    const int sms = sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    const int m16 = ((C < kMaxM ? C : kMaxM) + 15) / 16;
    const bool wg = bf16 && D % 8 == 0 && F % 8 == 0 && aligned16(x)
        && aligned16(w) && aligned16(out);
    const int mb = m16 <= 4 ? 1 : 2, nb = C <= 16 ? 1 : 2;
    const int bn = wg ? 64 * nb : kBN;
    const long tiles = (long)E * ((C + kMaxM - 1) / kMaxM)
        * ((F + bn - 1) / bn);
    const int per_sm = wg ? wg_ctas_per_sm(mb, nb) : kCtasPerSm;
    const int grid = (int)(tiles < per_sm * sms ? tiles : per_sm * sms);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (wg) {
        using B = __nv_bfloat16;
        const size_t smem = wg_smem_bytes(mb, nb, E);
        void (*kern)(const B*, const B*, B*, const void*, int, int, int,
                     int, int) =
            mb == 1 ? (nb == 1 ? &gmm_wgmma_kernel<1, 1>
                               : &gmm_wgmma_kernel<1, 2>)
                    : (nb == 1 ? &gmm_wgmma_kernel<2, 1>
                               : &gmm_wgmma_kernel<2, 2>);
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        kern<<<grid, kWgThreads, smem, st>>>(
            (const B*)x, (const B*)w, (B*)out, active, act_bytes, E, C, D, F);
        return (int)cudaGetLastError();
    }
#define GMM_SIMT(T, RT, VEC)                                              \
    {                                                                     \
        const size_t smem = simt_smem_bytes(RT, E);                      \
        err = cudaFuncSetAttribute(                                       \
            gmm_simt_kernel<T, RT, VEC>,                                  \
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);     \
        if (err != cudaSuccess) return (int)err;                          \
        gmm_simt_kernel<T, RT, VEC><<<grid, kSimtThreads, smem, st>>>(    \
            (const T*)x, (const T*)w, (T*)out, active, act_bytes, E, C, D, \
            F);                                                           \
        return (int)cudaGetLastError();                                   \
    }
    if (bf16) GMM_SIMT(__nv_bfloat16, 8, false)
    if (D % 4 != 0 || F % 4 != 0 || !aligned16(x) || !aligned16(w))
        GMM_SIMT(float, 8, false)
    switch (m16) {
        case 1: GMM_SIMT(float, 1, true)
        case 2: GMM_SIMT(float, 2, true)
        case 3: GMM_SIMT(float, 3, true)
        case 4: GMM_SIMT(float, 4, true)
        case 5: GMM_SIMT(float, 5, true)
        case 6: GMM_SIMT(float, 6, true)
        case 7: GMM_SIMT(float, 7, true)
        case 8: GMM_SIMT(float, 8, true)
        default: return (int)cudaErrorInvalidValue;
    }
#undef GMM_SIMT
}

}  // extern "C"
