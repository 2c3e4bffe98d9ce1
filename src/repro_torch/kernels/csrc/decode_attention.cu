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
// Design: one CTA of 16 warps per (KV head, batch row, group of up to
// MG query rows), so the G = 2 query rows of a head share every K/V
// load.  The cache is read in place in the engine's [B, S, KV, hd]
// layout by strides (no transpose per call).  Warp w takes positions
// w·U + 16·U·t .. +U-1 (U = 4): it loads the U keys and values first
// (lane l holds head dims l, l + 32, ...), reduces the U·G dot products
// in one interleaved butterfly, then folds the U positions into its
// online softmax.  Only positions < lengths[b] are visited, and the
// first position of every group a warp takes is valid, so its running
// max is finite before any masked position of the group (set to
// NEG_INF) is exponentiated.  The 16 warps' partial results are merged
// in a fixed warp order through shared memory; a warp that saw no
// position (running sum 0) gets weight 0.  That is the guard against
// the hazard of splitting the sequence axis: a split that begins at or
// past lengths[b] keeps max = NEG_INF, and a naive merge would weigh
// it by exp(NEG_INF - NEG_INF) = 1.  lengths[b] >= 1 is the caller's
// contract (the engine's lengths are pos + 1).
//
// Bound: bytes.  Each call must read lengths[b]·hd·2 K/V values per
// (b, h); at B = 8, KV = 8, hd = 128 in bfloat16 that is ~0.5 KB a
// position, a few MB a call, a few microseconds at 3.35 TB/s.  With
// one CTA per (h, b) only B·KV = 64 SMs pull bytes, and each warp's
// groups are latency-bound; splitting the sequence across CTAs is the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kU = 4;            // positions a warp loads before reducing
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

struct Strides {   // element strides of three leading axes (see launch)
    long a, b, c;
};

template <typename T, int NI, int MG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, Strides qs, Strides ks, Strides vs,
              Strides os, int G, int hd, float scale) {
    __shared__ float m_s[kWarps][MG], l_s[kWarps][MG];
    __shared__ float M_s[MG], L_s[MG];
    __shared__ float o_s[MG][NI * 32];

    const int kvh = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * MG;
    const int ng = min(MG, G - g0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int len = lengths[b];
    const T* kb = kc + b * ks.a + kvh * ks.c;     // + s·ks.b + d
    const T* vb = vc + b * vs.a + kvh * vs.c;

    float qr[MG][NI], m[MG], l[MG], acc[MG][NI];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
        m[g] = kNegInf;
        l[g] = 0.0f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
            const int d = lane + 32 * i;
            qr[g][i] = (g < ng && d < hd)
                ? to_f(q[b * qs.a + kvh * qs.b + (g0 + g) * qs.c + d])
                : 0.0f;
            acc[g][i] = 0.0f;
        }
    }

    for (int base = warp * kU; base < len; base += kWarps * kU) {
        float kr[kU][NI], vr[kU][NI];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const long p = base + u;
            const bool ok = p < len;
#pragma unroll
            for (int i = 0; i < NI; ++i) {
                const int d = lane + 32 * i;
                const bool okd = ok && d < hd;
                kr[u][i] = okd ? to_f(kb[p * ks.b + d]) : 0.0f;
                vr[u][i] = okd ? to_f(vb[p * vs.b + d]) : 0.0f;
            }
        }
        float s[kU][MG];
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
            for (int g = 0; g < MG; ++g) {
                float t = 0.0f;
#pragma unroll
                for (int i = 0; i < NI; ++i) t = fmaf(qr[g][i], kr[u][i], t);
                s[u][g] = t;
            }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
            for (int u = 0; u < kU; ++u)
#pragma unroll
                for (int g = 0; g < MG; ++g)
                    s[u][g] += __shfl_xor_sync(kFull, s[u][g], off);
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            float mx = m[g];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                s[u][g] = base + u < len ? s[u][g] * scale : kNegInf;
                mx = fmaxf(mx, s[u][g]);
            }
            const float alpha = expf(m[g] - mx);
            float p[kU], ps = 0.0f;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                p[u] = expf(s[u][g] - mx);
                ps += p[u];
            }
            l[g] = l[g] * alpha + ps;
#pragma unroll
            for (int i = 0; i < NI; ++i) {
                float a = acc[g][i] * alpha;
#pragma unroll
                for (int u = 0; u < kU; ++u) a = fmaf(p[u], vr[u][i], a);
                acc[g][i] = a;
            }
            m[g] = mx;
        }
    }

    // merge the warps' partial softmaxes in warp order
    if (lane == 0) {
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            m_s[warp][g] = m[g];
            l_s[warp][g] = l[g];
        }
    }
    for (int idx = threadIdx.x; idx < MG * NI * 32; idx += kThreads)
        (&o_s[0][0])[idx] = 0.0f;
    __syncthreads();
    if (threadIdx.x < MG) {
        const int g = threadIdx.x;
        float mx = kNegInf, tot = 0.0f;
        for (int w = 0; w < kWarps; ++w)
            if (l_s[w][g] > 0.0f) mx = fmaxf(mx, m_s[w][g]);
        for (int w = 0; w < kWarps; ++w)
            if (l_s[w][g] > 0.0f) tot += l_s[w][g] * expf(m_s[w][g] - mx);
        M_s[g] = mx;
        L_s[g] = tot;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
        if (warp == w) {
#pragma unroll
            for (int g = 0; g < MG; ++g) {
                const float wt = l[g] > 0.0f ? expf(m[g] - M_s[g]) : 0.0f;
#pragma unroll
                for (int i = 0; i < NI; ++i)
                    o_s[g][lane + 32 * i] += wt * acc[g][i];
            }
        }
        __syncthreads();
    }
    for (int idx = threadIdx.x; idx < ng * hd; idx += kThreads) {
        const int g = idx / hd, d = idx - g * hd;
        o[b * os.a + kvh * os.b + (g0 + g) * os.c + d] =
            from_f<T>(o_s[g][d] / fmaxf(L_s[g], 1e-30f));
    }
}

template <typename T, int NI, int MG>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lengths, void* o, int B, int KV, int G,
                   int hd, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, cudaStream_t stream) {
    const dim3 grid(KV, B, (G + MG - 1) / MG);
    decode_kernel<T, NI, MG><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, (const int*)lengths,
        (T*)o, qs, ks, vs, os, G, hd, scale);
    return cudaGetLastError();
}

template <typename T, int NI>
cudaError_t launch_g(int mg, const void* q, const void* kc, const void* vc,
                     const void* lengths, void* o, int B, int KV, int G,
                     int hd, Strides qs, Strides ks, Strides vs, Strides os,
                     float scale, cudaStream_t stream) {
    switch (mg) {
        case 1: return launch<T, NI, 1>(q, kc, vc, lengths, o, B, KV, G, hd,
                                        qs, ks, vs, os, scale, stream);
        case 2: return launch<T, NI, 2>(q, kc, vc, lengths, o, B, KV, G, hd,
                                        qs, ks, vs, os, scale, stream);
        case 4: return launch<T, NI, 4>(q, kc, vc, lengths, o, B, KV, G, hd,
                                        qs, ks, vs, os, scale, stream);
        case 8: return launch<T, NI, 8>(q, kc, vc, lengths, o, B, KV, G, hd,
                                        qs, ks, vs, os, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launch_t(int ni, int mg, const void* q, const void* kc,
                     const void* vc, const void* lengths, void* o, int B,
                     int KV, int G, int hd, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale,
                     cudaStream_t stream) {
    switch (ni) {
        case 1: return launch_g<T, 1>(mg, q, kc, vc, lengths, o, B, KV, G,
                                      hd, qs, ks, vs, os, scale, stream);
        case 2: return launch_g<T, 2>(mg, q, kc, vc, lengths, o, B, KV, G,
                                      hd, qs, ks, vs, os, scale, stream);
        case 4: return launch_g<T, 4>(mg, q, kc, vc, lengths, o, B, KV, G,
                                      hd, qs, ks, vs, os, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q [B, KV, G, hd] by strides (b, kv head, g); caches [B, S, KV, hd] by
// strides (b, s, kv head); o [B, KV, G, hd] by strides (b, kv head, g);
// the head dim contiguous everywhere; lengths [B] int32 >= 1.  bf16 != 0:
// q, caches and o are bfloat16, else float32.  ni = hd / 32 rounded up
// to 1, 2 or 4 (hd <= 128); mg = the query rows a CTA takes, 1, 2, 4 or
// 8.  Returns cudaGetLastError() of the launch.
int decode_attention_launch(int bf16, int ni, int mg, const void* q,
                            const void* kc, const void* vc,
                            const void* lengths, void* o, int B, int KV,
                            int G, int hd, long qsb, long qsk, long qsg,
                            long ksb, long kss, long ksk, long vsb,
                            long vss, long vsk, long osb, long osk,
                            long osg, float scale, void* stream) {
    if (B == 0 || KV == 0 || G == 0) return 0;
    if (hd > 32 * ni) return (int)cudaErrorInvalidValue;
    const Strides qs{qsb, qsk, qsg}, ks{ksb, kss, ksk}, vs{vsb, vss, vsk},
        os{osb, osk, osg};
    if (bf16)
        return (int)launch_t<__nv_bfloat16>(ni, mg, q, kc, vc, lengths, o, B,
                                            KV, G, hd, qs, ks, vs, os, scale,
                                            (cudaStream_t)stream);
    return (int)launch_t<float>(ni, mg, q, kc, vc, lengths, o, B, KV, G, hd,
                                qs, ks, vs, os, scale, (cudaStream_t)stream);
}

}  // extern "C"
