// K7's backward: the gradient of the grouped (per-expert) matrix product
// out[e] = x[e] @ w[e] (csrc/moe_gmm.cu) given dy = d out [E, C, F]:
//   dx[e] = dy[e] · w[e]ᵀ   [C, F]·[F, D] -> dx [E, C, D],
//   dw[e] = x[e]ᵀ · dy[e]   [D, C]·[C, F] -> dw [E, D, F],
// for the experts that `active` marks; the others' dx and dw are zero.
//
// Replaces the gradient of the JAX package's Pallas TPU kernel
//   src/repro/kernels/moe_gmm.py : moe_gmm
// (the JAX package differentiates the einsums of
// src/repro/models/layers/moe.py around it) and computes the plain
// gradient, autograd of kernels/ref.py:moe_gmm_ref: products summed in
// float32, one cast of each sum to bfloat16.  bfloat16 only, with D and
// F multiples of 8 and 16-byte aligned pointers (the wrapper sends
// float32 and unaligned bfloat16 to two launches of the forward kernel
// on transposed copies).
//
// What bounds it on the H100.  At OLMoE's train step (E 64, D 2048,
// F 1024, C = 640) the two products are 172 GFLOP each: operations,
// 0.347 ms on the tensor cores.  At C = 80 (40 of 64 experts active)
// they are 27 GFLOP against the bytes of w read and dw written once
// (168 MB each): bytes, 0.110 ms.  The design serves both:
//
// * Operands read where they lie.  No transposed copy: the Tensor
//   Memory Accelerator (TMA) copies 64 x 64 boxes of dy, x and w into
//   shared memory in the 128-byte swizzle, and wgmma reads each
//   operand in the orientation it has there.  dx: A = a dy block
//   [rows of C x 64 of F] and B = a w block [rows of D x 64 of F], both
//   K-major (F is the depth).  dw: A = an x block [64 of C x 64 of D] and
//   B = a dy block [64 of C x 64 of F], both MN-major (C is the depth),
//   the transpose flags of wgmma set.  Boxes past C, D or F are
//   zero-filled by the copy (in the depth) or left out (in the rows and
//   columns, whose outputs are not stored).
// * One persistent launch over both products.  The tiles are 128 x 256
//   outputs: dx tiles (expert, 128 rows of C, 256 columns of D), then
//   dw tiles (expert, 128 rows of D, 256 columns of F), of the ACTIVE
//   experts (read on the device: no host sync, the launch can be
//   captured in a CUDA graph); CTA b of G takes tiles b, b + G, ...
//   (kernels/moe_gmm.py:bwd_tile_schedule is the same schedule in
//   Python).  Each output element is summed by one CTA over ascending
//   depth: no split of the depth, no atomics, the same bits every run.
//   The inactive experts' dx and dw are zeroed after the tiles.
// * Tensor cores kept fed.  One CTA an SM: a producer warp whose one
//   thread keeps a ring of 4 stages (48 KB each: 128 x 64 of A, 256 x
//   64 of B) in flight by TMA on mbarriers, and two consumer
//   warpgroups, each 64 rows x 256 columns of the tile (128 float32
//   sums a thread) by m64n256k16 steps, which wait for a stage's
//   products only after issuing the next stage's (wgmma.wait_group 1),
//   so the tensor cores never idle between stages.  While the consumers
//   store a tile, the producer is already loading the next one.
// * Stores by 16 bytes: each quad of threads transposes its 4 x 4
//   block of bfloat16 pairs by two shuffles, so every thread writes 8
//   consecutive columns of one row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // rows of an output tile
constexpr int kBN = 256;          // columns of an output tile
constexpr int kBK = 64;           // depth of one stage
constexpr int kStages = 4;        // stages of the ring
constexpr int kBlock = 64 * 128;  // bytes of one 64 x 64 bf16 box
constexpr int kStageBytes = (kBM + kBN) / 64 * kBlock;   // 48 KB
constexpr int kConsumerWarps = 8; // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;       // + producer
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
    return (a + b - 1) / b;
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

// zero the [per16] 16-byte chunks of each inactive expert list[n_act, E)
// of `o`, over the grid
__device__ void zero_inactive(__nv_bfloat16* o, const int* list, int n_act,
                              int E, long per16) {
    const long total = (long)(E - n_act) * per16;
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (long)gridDim.x * blockDim.x) {
        const long k = i / per16;
        o4[(long)list[n_act + k] * per16 + (i - k * per16)] =
            make_uint4(0, 0, 0, 0);
    }
}

// The tiles of CTA b of G: b, b + G, b + 2G, ... of the dx tiles of the
// active experts (expert-major, then 128-row block of C, then 256-column
// block of D), followed by their dw tiles (expert-major, then 128-row
// block of D, then 256-column block of F).
struct BwdTiles {
    int n_dx, per_dx, nnb_dx, per_dw, nnb_dw, count;
    __device__ BwdTiles(int n_act, int C, int D, int F, bool dx, bool dw) {
        nnb_dx = cdiv(D, kBN);
        per_dx = dx ? cdiv(C, kBM) * nnb_dx : 0;
        nnb_dw = cdiv(F, kBN);
        per_dw = dw ? cdiv(D, kBM) * nnb_dw : 0;
        n_dx = n_act * per_dx;
        const int total = n_dx + n_act * per_dw;
        count = total > (int)blockIdx.x
            ? (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
            : 0;
    }
    // this CTA's j-th tile -> dx or dw, expert, first row, first column
    __device__ void at(int j, const int* list, bool& is_dx, int& e, int& r0,
                       int& n0) const {
        int t = (int)blockIdx.x + j * (int)gridDim.x;
        is_dx = t < n_dx;
        if (!is_dx) t -= n_dx;
        const int per = is_dx ? per_dx : per_dw;
        const int nnb = is_dx ? nnb_dx : nnb_dw;
        const int k = t / per, rem = t - k * per;
        e = list[k];
        r0 = (rem / nnb) * kBM;
        n0 = (rem % nnb) * kBN;
    }
};

// ------------------------------------------------ barriers, TMA, wgmma
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}
// the barriers' initialisation, visible to the copy engine
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}
// one arrival that also expects `bytes` from the copies of this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
// whether the phase of parity `parity` has completed (a bounded wait)
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}
// wait until it has
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    while (!mbar_try(bar, parity)) {
    }
}
// one 64 x 64 box at (c0 innermost, c1, c2) of the tensor `map` into
// shared memory at `dst`, completing on barrier `bar`
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int c1, int c2,
                                        uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
           "r"(c1), "r"(c2), "r"(bar) : "memory");
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

// d (+)= A·B, m64n256k16, A and B K-major
__device__ __forceinline__ void wgmma_kk(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A·B, m64n256k16, A and B MN-major
__device__ __forceinline__ void wgmma_mn(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 1, 1;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
}

// (a, b) -> one packed bfloat16 pair, round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
}

// v[s] of quad thread t (a 4 x 4 block M[t][s]) -> M[s][t]: two rounds
// of exchanges, the off-diagonal 2 x 2 blocks (lanes t ^ 2), then the
// off-diagonal entries of each 2 x 2 block (lanes t ^ 1)
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
    const bool hi = t & 2, lo = t & 1;
    uint32_t r0 = __shfl_xor_sync(kFull, hi ? v[0] : v[2], 2);
    uint32_t r1 = __shfl_xor_sync(kFull, hi ? v[1] : v[3], 2);
    if (hi) { v[0] = r0; v[1] = r1; } else { v[2] = r0; v[3] = r1; }
    r0 = __shfl_xor_sync(kFull, lo ? v[0] : v[1], 1);
    r1 = __shfl_xor_sync(kFull, lo ? v[2] : v[3], 1);
    if (lo) { v[0] = r0; v[2] = r1; } else { v[1] = r0; v[3] = r1; }
}

// One consumer warpgroup's 64 x 256 part of a tile, to bfloat16 at `o`
// (the tile's first element, rows `ld` apart), rows < `rows` and
// columns < `cols` of the tile only.  acc[4j + q]: row 16·warp + g (+ 8
// for q >= 2), column 8j + 2t (+ 1 for odd q); after the quad transpose
// thread t holds columns 8(4p + t) .. + 7 of its two rows.
__device__ __forceinline__ void store_tile(const float (&acc)[128],
                                           __nv_bfloat16* o, long ld,
                                           int row0, int rows, int cols) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int ra = row0 + ((threadIdx.x >> 5) & 3) * 16 + g, rb = ra + 8;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
        uint32_t va[4], vb[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const int j = 4 * p + s;
            va[s] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
            vb[s] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
        quad_transpose(va, t);
        quad_transpose(vb, t);
        const int col = 8 * (4 * p + t);
        if (col < cols) {        // cols % 8 == 0: the 8 columns are in
            if (ra < rows)
                *reinterpret_cast<uint4*>(o + ra * ld + col) =
                    make_uint4(va[0], va[1], va[2], va[3]);
            if (rb < rows)
                *reinterpret_cast<uint4*>(o + rb * ld + col) =
                    make_uint4(vb[0], vb[1], vb[2], vb[3]);
        }
    }
}

// the rows and columns of a tile's output, and its depth
struct TileShape {
    int M, N, K;
};
__device__ __forceinline__ TileShape tile_shape(bool is_dx, int C, int D,
                                                int F) {
    return is_dx ? TileShape{C, D, F} : TileShape{D, F, C};
}

// One consumer warpgroup's float32 sums of one tile over its nk stages
// of the ring (cursor s, phase ph): four wgmma steps of 16 a stage, each
// stage released to the producer once the next one's products are
// issued and its own have completed.  dx: A (dy) and B (w) K-major, a
// step 32 bytes along each row; dw: A (x) and B (dy) MN-major, a step
// 16 rows of 128 bytes.  acc is overwritten by the first step.
template <bool kDX>
__device__ __forceinline__ void tile_sums(float (&acc)[128], int nk,
                                          uint32_t base, uint32_t full0,
                                          uint32_t empty0, int wg, int lane,
                                          int& s, uint32_t& ph) {
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full0 + 8 * s, ph);
        const uint32_t sA = base + s * kStageBytes + wg * kBlock;
        const uint32_t sB = base + s * kStageBytes + (kBM / 64) * kBlock;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
            if constexpr (kDX)
                wgmma_kk(acc, sw128_desc(sA + kk * 32, 16, 1024),
                         sw128_desc(sB + kk * 32, 16, 1024),
                         kb > 0 || kk > 0);
            else
                wgmma_mn(acc, sw128_desc(sA + kk * 2048, kBlock, 1024),
                         sw128_desc(sB + kk * 2048, kBlock, 1024),
                         kb > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();            // the previous stage's products
        if (kb > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = s;
        if (++s == kStages) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_dy,
                     const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     __nv_bfloat16* __restrict__ dx,
                     __nv_bfloat16* __restrict__ dw, const void* active,
                     int act_bytes, int E, int C, int D, int F) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the ring, 1024-byte aligned (the swizzle's period), the barriers
    // (full[kStages], then empty[kStages]), then the expert list
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* ring = smem_raw + (base - raw);
    const uint32_t full0 = base + kStages * kStageBytes;
    const uint32_t empty0 = full0 + 8 * kStages;
    int* list = reinterpret_cast<int*>(ring + kStages * kStageBytes
                                       + 16 * kStages);
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, kConsumerWarps);
        }
        fence_barrier_init();
    }
    const int n_act = expert_list(active, act_bytes, E, list);  // syncs
    const BwdTiles tiles(n_act, C, D, F, dx != nullptr, dw != nullptr);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (warp == kConsumerWarps) {
        // ------------------------------------------------- the producer
        if (lane == 0) {
            int s = 0;
            uint32_t ph = 0;
            for (int j = 0; j < tiles.count; ++j) {
                bool is_dx;
                int e, r0, n0;
                tiles.at(j, list, is_dx, e, r0, n0);
                const TileShape ts = tile_shape(is_dx, C, D, F);
                // the boxes of A (64 rows each) and B inside the bounds
                const int na = min(kBM / 64, cdiv(ts.M - r0, 64));
                const int nb = min(kBN / 64, cdiv(ts.N - n0, 64));
                const uint32_t bytes = (na + nb) * kBlock;
                const int nk = cdiv(ts.K, kBK);
                for (int kb = 0; kb < nk; ++kb) {
                    mbar_wait(empty0 + 8 * s, ph ^ 1);
                    const uint32_t bar = full0 + 8 * s;
                    mbar_expect_tx(bar, bytes);
                    const uint32_t sA = base + s * kStageBytes;
                    const uint32_t sB = sA + (kBM / 64) * kBlock;
                    const int k0 = kb * kBK;
                    if (is_dx) {        // dy [C, F] rows, w [D, F] rows
                        for (int i = 0; i < na; ++i)
                            tma_box(sA + i * kBlock, &tm_dy, k0, r0 + 64 * i,
                                    e, bar);
                        for (int i = 0; i < nb; ++i)
                            tma_box(sB + i * kBlock, &tm_w, k0, n0 + 64 * i,
                                    e, bar);
                    } else {            // x [C, D] and dy [C, F] columns
                        for (int i = 0; i < na; ++i)
                            tma_box(sA + i * kBlock, &tm_x, r0 + 64 * i, k0,
                                    e, bar);
                        for (int i = 0; i < nb; ++i)
                            tma_box(sB + i * kBlock, &tm_dy, n0 + 64 * i, k0,
                                    e, bar);
                    }
                    if (++s == kStages) { s = 0; ph ^= 1; }
                }
            }
        }
    } else {
        // ------------------------------------- the consumer warpgroups
        const int wg = warp >> 2;           // 64 rows of the tile each
        int s = 0;
        uint32_t ph = 0;
        float acc[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
        for (int j = 0; j < tiles.count; ++j) {
            bool is_dx;
            int e, r0, n0;
            tiles.at(j, list, is_dx, e, r0, n0);
            const TileShape ts = tile_shape(is_dx, C, D, F);
            const int nk = cdiv(ts.K, kBK);
            if (is_dx)
                tile_sums<true>(acc, nk, base, full0, empty0, wg, lane, s, ph);
            else
                tile_sums<false>(acc, nk, base, full0, empty0, wg, lane, s,
                                 ph);
            __nv_bfloat16* o = is_dx
                ? dx + ((long)e * C + r0) * D + n0
                : dw + ((long)e * D + r0) * F + n0;
            store_tile(acc, o, ts.N, 64 * wg, min(kBM, ts.M - r0),
                       min(kBN, ts.N - n0));
        }
    }
    if (dx != nullptr) zero_inactive(dx, list, n_act, E, (long)C * D / 8);
    if (dw != nullptr) zero_inactive(dw, list, n_act, E, (long)D * F / 8);
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

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// the map of a contiguous bf16 tensor [E, rows, inner] cut in 64 x 64
// boxes (inner x rows), 128-byte swizzle, zeros past its bounds
bool box_map(CUtensorMap* map, const void* ptr, int E, int rows,
             int inner) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                                (cuuint64_t)E};
    const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                   (cuuint64_t)inner * rows * 2};
    const cuuint32_t box[3] = {64, 64, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
              const_cast<void*>(ptr), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// shared memory of one CTA at E experts: the alignment slack, the ring,
// the barriers and the expert list
int smem_bytes(int E) {
    return 1024 + kStages * kStageBytes + 16 * kStages + 4 * (E + 1);
}

}  // namespace

extern "C" {

// dy [E, C, F], x [E, C, D], w [E, D, F] -> dx [E, C, D] and dw [E, D,
// F], all contiguous bfloat16; dx or dw null leaves that product out.
// `active` is [E] bool (act_bytes 1) or int32 (4), or null (act_bytes
// 0: every expert).  E, C, D, F >= 1, D and F multiples of 8, every
// pointer 16-byte aligned, else cudaErrorInvalidValue without a launch.
// The grid is one CTA an SM (fewer when there are fewer tiles).
// Returns cudaGetLastError() of the launch.
int moe_gmm_bwd_launch(const void* dy, const void* x, const void* w,
                       void* dx, void* dw, const void* active,
                       int act_bytes, int E, int C, int D, int F,
                       void* stream) {
    if (dx == nullptr && dw == nullptr) return 0;
    if (E < 1 || C < 1 || D < 1 || F < 1 || D % 8 != 0 || F % 8 != 0
            || !aligned16(dy) || !aligned16(x) || !aligned16(w)
            || (dx != nullptr && !aligned16(dx))
            || (dw != nullptr && !aligned16(dw)))
        return (int)cudaErrorInvalidValue;
    const int smem = smem_bytes(E);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    const int sms = sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    CUtensorMap m_dy, m_x, m_w;
    if (!box_map(&m_dy, dy, E, C, F) || !box_map(&m_x, x, E, C, D)
            || !box_map(&m_w, w, E, D, F))
        return (int)cudaErrorInvalidValue;
    const long tiles = (long)E
        * ((dx != nullptr ? (long)cdiv(C, kBM) * cdiv(D, kBN) : 0)
           + (dw != nullptr ? (long)cdiv(D, kBM) * cdiv(F, kBN) : 0));
    const int grid = (int)(tiles < sms ? tiles : sms);
    cudaError_t err = cudaFuncSetAttribute(
        gmm_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    gmm_bwd_wgmma_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        m_dy, m_x, m_w, (__nv_bfloat16*)dx, (__nv_bfloat16*)dw, active,
        act_bytes, E, C, D, F);
    return (int)cudaGetLastError();
}

}  // extern "C"
