// Streaming-softmax (flash) attention for Hopper (sm_90a): GQA, causal and
// sliding-window masks, tanh logit softcap, any Sq and Skv.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel), whose sequential kv grid axis carries a
// running max, a running sum and an f32 accumulator in VMEM scratch.  Here
// one block of 256 threads owns one (batch, q-head, 64-query tile) and a
// loop inside the block walks the 64-key tiles, the state kept in
// registers.  Computes what the plain version (kernels/ref.py
// mha_reference) computes:
//   s = (q . k) * scale ; s = tanh(s / cap) * cap   (cap != 0)
//   s = NEG_INF where masked (key past Skv; key > query if causal; key <=
//       query - window if window)
//   o = softmax(s) @ v, kv head = q head / (H / KV)
// with q/k/v/o in float32 or bfloat16 and all arithmetic in float32.
//
// Layout: the kernel takes element strides for the batch, head and
// sequence dimensions of each tensor (the head dimension must be
// contiguous), so the model hands it its (B, S, H, hd) activations as
// (B, H, S, hd) views without a transposing copy.
//
// Masking follows the TPU kernel exactly: a masked score is NEG_INF, not
// -inf, and p = exp(s - m).  A row that has seen only masked keys has
// m = NEG_INF and takes p = 1 for them; the first unmasked key raises m and
// alpha = exp(NEG_INF - m) = 0 wipes that.  A row with no unmasked key at
// all ends as the plain version's uniform average over every key (keys
// past Skv take p = 0, so they are not counted in that average).  The
// block visits only the key tiles that hold an unmasked key for some row
// of its query tile (the causal/window band): at S = 1,536 with window
// 1,024 that skips more than half of the tiles; a query tile with a row
// that has no unmasked key (window with Sq > Skv + window - 1) visits
// every tile, as the plain version averages over every key.
//
// What bounds it on the card: operations.  At hymba-1.5b's prefill (B=4,
// H=25, KV=5, S=1,536, hd=64, window 1,024) the unmasked (q, k) pairs take
// 26.9 GFLOP, about 27 us at the bf16 tensor-core peak, against about
// 14 us for the 47 MB it must move.  This first version computes in
// float32 on the CUDA cores (67 TFLOP/s peak), so it cannot come near that
// bound: Q.K^T runs as a 4x4 register tile per thread over float4
// shared-memory reads (row stride hd + 4: aligned and free of bank
// conflicts), P.V as a 4 x hd/16 tile.  Tensor cores (wgmma) and TMA
// loads are the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define FA_THREADS 256
#define FA_BQ 64
#define FA_BK 64
#define FA_NEG_INF (-1e30f)

struct FaStrides {
    long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t fa_smem_bytes() {
    return sizeof(float) * ((size_t)FA_BQ * (HD + 4) + (size_t)FA_BK * (HD + 4)
                            + (size_t)FA_BK * HD + (size_t)FA_BQ * (FA_BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int G, int Sq, int Skv, FaStrides st, int causal,
                       int window, float scale, float softcap) {
    constexpr int QS = HD + 4;          // row stride of the Q and K tiles
    constexpr int PS = FA_BK + 1;       // row stride of the P tile
    constexpr int CPT = HD / 16;        // output columns per thread
    extern __shared__ float4 fa_smem4[];
    float* sQ = reinterpret_cast<float*>(fa_smem4);     // BQ x QS
    float* sK = sQ + FA_BQ * QS;                        // BK x QS
    float* sV = sK + FA_BK * QS;                        // BK x HD
    float* sP = sV + FA_BK * HD;                        // BQ x PS

    // thread (tx, ty) owns query rows ty + 16 i and, for the scores, keys
    // tx + 16 j (i, j < 4); for the output, columns tx + 16 c (c < CPT).
    // The 16 threads of one row group are one half-warp, so row
    // reductions are four xor-shuffles.
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * FA_BQ;
    const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
    const T* qp = q + b * st.qb + h * st.qh;
    const T* kp = k + b * st.kb + kvh * st.kh;
    const T* vp = v + b * st.vb + kvh * st.vh;
    T* op = o + b * st.ob + h * st.oh;

    for (int e = tid; e < FA_BQ * HD; e += FA_THREADS) {
        const int r = e / HD, d = e % HD, qi = q0 + r;
        sQ[r * QS + d] = qi < Sq ? fa_load(qp + (long long)qi * st.qs + d)
                                 : 0.0f;
    }

    // the key tiles to visit
    const int q_last = min(q0 + FA_BQ, Sq) - 1;
    int k_begin = 0, k_end = Skv;
    const bool empty_row = window > 0 && q_last > Skv + window - 2;
    if (!empty_row) {
        if (window > 0) k_begin = max(0, q0 - window + 1);
        if (causal) k_end = min(Skv, q_last + 1);
    }
    const int kt_begin = k_begin / FA_BK;
    const int kt_end = k_end > k_begin ? (k_end - 1) / FA_BK + 1 : kt_begin;

    float m[4], l[4], acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = FA_NEG_INF;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
    }

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * FA_BK;
        __syncthreads();                 // Q stored / last tile's P.V done
        for (int e = tid; e < FA_BK * HD; e += FA_THREADS) {
            const int r = e / HD, d = e % HD, kj = k0 + r;
            const bool ok = kj < Skv;
            sK[r * QS + d] = ok ? fa_load(kp + (long long)kj * st.ks + d)
                                : 0.0f;
            sV[r * HD + d] = ok ? fa_load(vp + (long long)kj * st.vs + d)
                                : 0.0f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
            float4 qa[4], kb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qa[i] = *reinterpret_cast<const float4*>(
                    &sQ[(ty + 16 * i) * QS + d]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kb[j] = *reinterpret_cast<const float4*>(
                    &sK[(tx + 16 * j) * QS + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float a = s[i][j];
                    a = fmaf(qa[i].x, kb[j].x, a);
                    a = fmaf(qa[i].y, kb[j].y, a);
                    a = fmaf(qa[i].z, kb[j].z, a);
                    a = fmaf(qa[i].w, kb[j].w, a);
                    s[i][j] = a;
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qi = q0 + ty + 16 * i;
            float mx = FA_NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kj = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
                bool ok = kj < Skv;
                if (causal) ok = ok && kj <= qi;
                if (window > 0) ok = ok && kj > qi - window;
                s[i][j] = ok ? x : FA_NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                // keys past Skv do not exist (the TPU kernel pads them and
                // would count them in a row with no unmasked key)
                const float p = k0 + tx + 16 * j < Skv
                                    ? expf(s[i][j] - m_new) : 0.0f;
                sP[(ty + 16 * i) * PS + tx + 16 * j] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();                 // the P tile is complete

#pragma unroll 4
        for (int kk = 0; kk < FA_BK; ++kk) {
            float pv[4], vv[CPT];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PS + kk];
#pragma unroll
            for (int c = 0; c < CPT; ++c) vv[c] = sV[kk * HD + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < CPT; ++c)
                    acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
        if (qi < Sq) {
            const float den = fmaxf(l[i], 1e-30f);
            T* orow = op + (long long)qi * st.os;
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                fa_store(orow + tx + 16 * c, acc[i][c] / den);
        }
    }
}

template <typename T, int HD>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int Sq, int Skv,
                     const FaStrides& st, int causal, int window,
                     float scale, float softcap, cudaStream_t stream) {
    const size_t smem = fa_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
    flash_attention_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H / KV, Sq, Skv, st,
        causal, window, scale, softcap);
    return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(int hd, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int KV, int Sq, int Skv,
                       const FaStrides& st, int causal, int window,
                       float scale, float softcap, cudaStream_t stream) {
    switch (hd) {
    case 16: return fa_launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, st,
                                     causal, window, scale, softcap, stream);
    case 32: return fa_launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, st,
                                     causal, window, scale, softcap, stream);
    case 64: return fa_launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, st,
                                     causal, window, scale, softcap, stream);
    case 128: return fa_launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, st,
                                       causal, window, scale, softcap,
                                       stream);
    case 256: return fa_launch<T, 256>(q, k, v, o, B, H, KV, Sq, Skv, st,
                                       causal, window, scale, softcap,
                                       stream);
    default: return (int)cudaErrorInvalidValue;
    }
}

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (batch,
// head, sequence) of q, k, v and o in that order.
extern "C" int flash_attention_launch(
        const void* q, const void* k, const void* v, void* o,
        int B, int H, int KV, int Sq, int Skv, int hd, int dtype,
        const long long* strides, int causal, int window, float scale,
        float softcap, void* stream) {
    if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1
            || B > 65535 || H > 65535 || window < 0)
        return (int)cudaErrorInvalidValue;
    FaStrides st = {strides[0], strides[1], strides[2], strides[3],
                    strides[4], strides[5], strides[6], strides[7],
                    strides[8], strides[9], strides[10], strides[11]};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return fa_dispatch<float>(hd, q, k, v, o, B, H, KV, Sq, Skv, st,
                                  causal, window, scale, softcap, s);
    if (dtype == 1)
        return fa_dispatch<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Skv,
                                          st, causal, window, scale, softcap,
                                          s);
    return (int)cudaErrorInvalidValue;
}
