// The gradient of the streaming-softmax attention (flash_attention.cu) for
// Hopper (sm_90a): dq, dk and dv from q, k, v, the forward's output and
// the output's gradient; GQA, causal and sliding-window masks, tanh logit
// softcap, any Sq and Skv, bfloat16 or float32, head dims 16-256.
//
// Replaces no TPU kernel: the JAX package has no backward kernel (its
// training gradient is autodiff of the jnp attention in
// src/repro/models/layers.py attend).  The port's train-mode forward runs
// the hand-written forward kernel, so its gradient needs one too.
// Computes what the plain version (kernels/ref.py mha_backward_reference)
// computes, in float32:
//   s   = (q . k) * scale ; t = tanh(s / cap), s = t * cap   (cap != 0)
//   P   = exp(s - lse) where unmasked, 0 where masked; a row with no
//         unmasked key (window with q >= Skv + window - 1) averages every
//         key: P = 1 / Skv, and none of its scores gets a gradient
//   D   = rowsum(dout * out)
//   dS  = P * (dout . v^T - D) * (1 - t^2 with a softcap), 0 where masked
//   dq  = dS . k * scale ; dk = sum over the G q heads of a kv head of
//         dS^T . q * scale ; dv = that sum of P^T . dout
//
// Design, two kernels on the stream, both on the CUDA cores in float32
// (a simple kernel that is right: the tensor-core redesign, mma.sync or
// wgmma fed by TMA, is later work):
//
// * fa_bwd_dq: one block per (batch, q head, query tile).  It recomputes
//   its rows' statistics (a first pass over the key tiles of the
//   causal/window band, q . k only, running max and sum: the forward
//   kernel is left as it is, so serving writes nothing more), writes each
//   row's log-sum-exp and D for the second kernel, then a second pass over
//   the same key tiles accumulates dq in registers.
// * fa_bwd_dkdv: one block per (batch, kv head, key tile): it walks the G
//   q heads of its group and, for each, the query tiles that hold an
//   unmasked query for one of its keys (the band, plus the rows with no
//   unmasked key), so dk and dv are summed over the group in registers,
//   without atomics.
//
// Each 256-thread block computes a BQ x BK tile of s and of dout . v^T as
// a (BQ / 16) x (BK / 16) register tile per thread over float4 reads of
// shared memory, as the forward's float32 instance does; P and dS go
// through shared memory into the products with k, q and dout.  Inputs are
// read in their own dtype and held in shared memory as float32.  Tiles
// are 64 x 64, and 32 x 32 at head dim 256 (shared memory).  Strides are
// the caller's (the head dimension contiguous), so the model's (B, S, H,
// hd) activations and gradients arrive as (B, H, S, hd) views.
//
// What bounds it on the card: at hymba-1.5b's training shape (B=4, H=25,
// KV=5, S=4,096, hd 64, causal, window 1,024) the unmasked (q, k) pairs
// need five products of 2 hd flops each (q . k, dout . v, P^T . dout,
// dS^T . q, dS . k: 235 GFLOP, about 0.24 ms at the bf16 tensor-core
// peak) and an exponential each.  This kernel does eight products (the
// statistics pass and the recomputations of q . k and dout . v in the
// second kernel) in float32 on the CUDA cores, whose peak is 67 TFLOP/s:
// it is bound by the CUDA cores' issue rate, far above the tensor-core
// bound; the redesign onto the tensor cores is what closes that gap.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define FB_NEG_INF (-1e30f)
#define FB_THREADS 256

typedef __nv_bfloat16 bf16;

struct FbStrides {
    // (batch, head, sequence) element strides of q, k, v, o, do, dq, dk, dv
    long long s[24];
};

__device__ __forceinline__ float fb_ld(const float* p) { return *p; }
__device__ __forceinline__ float fb_ld(const bf16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void fb_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void fb_st(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool fb_unmasked(int qi, int kj, int Skv,
                                            int causal, int window) {
    bool ok = kj < Skv;
    if (causal) ok = ok && kj <= qi;
    if (window > 0) ok = ok && kj > qi - window;
    return ok;
}

// a row with no unmasked key at all
__device__ __forceinline__ bool fb_dead(int qi, int Skv, int window) {
    return window > 0 && qi >= Skv + window - 1;
}

template <int HD>
struct FbTile {
    static constexpr int B = HD >= 256 ? 32 : 64;   // BQ = BK
    static constexpr int R = B / 16;                // rows/cols per thread
    static constexpr int LD = HD + 4;               // padded f32 row
    static constexpr int PS = B + 1;                // padded P / dS row
    static constexpr int CPT = HD / 16;             // output cols per thread
};

// rows [r0, r0 + B) of a (seq, hd) slice with row stride rs -> f32 shared
// rows of stride LD; rows at or past n are zero
template <int HD, typename T>
__device__ __forceinline__ void fb_load_rows(float* dst, const T* src,
                                             long long rs, int r0, int n) {
    using Tl = FbTile<HD>;
    for (int e = threadIdx.x; e < Tl::B * HD; e += FB_THREADS) {
        const int r = e / HD, d = e % HD, ri = r0 + r;
        dst[r * Tl::LD + d] = ri < n ? fb_ld(src + (long long)ri * rs + d)
                                     : 0.0f;
    }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over f32 shared
// tiles of row stride LD
template <int HD>
__device__ __forceinline__ void fb_dot_tile(const float* a, const float* b,
                                            float (&acc)[FbTile<HD>::R]
                                                        [FbTile<HD>::R],
                                            int tx, int ty) {
    using Tl = FbTile<HD>;
    constexpr int R = Tl::R, LD = Tl::LD;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
        float4 av[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
            av[i] = *reinterpret_cast<const float4*>(
                &a[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < R; ++j)
            bv[j] = *reinterpret_cast<const float4*>(
                &b[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) {
                float x = acc[i][j];
                x = fmaf(av[i].x, bv[j].x, x);
                x = fmaf(av[i].y, bv[j].y, x);
                x = fmaf(av[i].z, bv[j].z, x);
                x = fmaf(av[i].w, bv[j].w, x);
                acc[i][j] = x;
            }
    }
}

// ---------------------------------------------------------------------------
// dq (and the row statistics lse, D)
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t fb_dq_smem_floats() {
    using Tl = FbTile<HD>;
    return (size_t)4 * Tl::B * Tl::LD + (size_t)Tl::B * Tl::PS;
}

template <int HD, typename T>
__global__ void __launch_bounds__(FB_THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, T* __restrict__ dq,
                 float* __restrict__ lse_out, float* __restrict__ d_out,
                 int H, int G, int Sq, int Skv, FbStrides st, int causal,
                 int window, float scale, float softcap) {
    using Tl = FbTile<HD>;
    constexpr int BT = Tl::B, R = Tl::R, LD = Tl::LD, PS = Tl::PS;
    constexpr int CPT = Tl::CPT;
    extern __shared__ float4 fb_smem4[];
    float* sQ = reinterpret_cast<float*>(fb_smem4);     // BT x LD
    float* sDO = sQ + BT * LD;                          // BT x LD
    float* sK = sDO + BT * LD;                          // BT x LD
    float* sV = sK + BT * LD;                           // BT x LD
    float* sS = sV + BT * LD;                           // BT x PS (dS)

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / G;
    const long long* s = st.s;
    const T* qp = q + b * s[0] + h * s[1];
    const T* kp = k + b * s[3] + kvh * s[4];
    const T* vp = v + b * s[6] + kvh * s[7];
    const T* op = o + b * s[9] + h * s[10];
    const T* dop = dout + b * s[12] + h * s[13];
    T* dqp = dq + b * s[15] + h * s[16];
    const long long row_stat = ((long long)b * H + h) * Sq;

    fb_load_rows<HD>(sQ, qp, s[2], q0, Sq);
    fb_load_rows<HD>(sDO, dop, s[14], q0, Sq);
    // sK holds this tile's out rows for D = rowsum(dout * out)
    fb_load_rows<HD>(sK, op, s[11], q0, Sq);
    __syncthreads();

    // D: 16 threads per row (a half-warp), BT / 16 rows each pass
    float Dr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        float acc = 0.0f;
        for (int d = tx; d < HD; d += 16)
            acc = fmaf(sDO[r * LD + d], sK[r * LD + d], acc);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        Dr[i] = acc;
    }

    // the key tiles of the band (every tile when a row has no unmasked key)
    const int q_last = min(q0 + BT, Sq) - 1;
    int k_begin = 0, k_end = Skv;
    if (!(window > 0 && q_last > Skv + window - 2)) {
        if (window > 0) k_begin = max(0, q0 - window + 1);
        if (causal) k_end = min(Skv, q_last + 1);
    }
    const int kt_begin = k_begin / BT;
    const int kt_end = k_end > k_begin ? (k_end - 1) / BT + 1 : kt_begin;

    // pass 1: the rows' running max and sum of exp over the band
    float m[R], l[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        m[i] = FB_NEG_INF;
        l[i] = 0.0f;
    }
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BT;
        __syncthreads();                    // the last tile's reads done
        fb_load_rows<HD>(sK, kp, s[5], k0, Skv);
        __syncthreads();
        float sc[R][R];
        fb_dot_tile<HD>(sQ, sK, sc, tx, ty);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int qi = q0 + ty + 16 * i;
            float mx = FB_NEG_INF;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int kj = k0 + tx + 16 * j;
                float x = sc[i][j] * scale;
                if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
                sc[i][j] = fb_unmasked(qi, kj, Skv, causal, window)
                               ? x : FB_NEG_INF;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < R; ++j)
                rs += sc[i][j] > FB_NEG_INF ? expf(sc[i][j] - m_new) : 0.0f;
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * expf(m[i] - m_new) + rs;
            m[i] = m_new;
        }
    }
    float lse[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int qi = q0 + ty + 16 * i;
        const bool dead = fb_dead(qi, Skv, window) || l[i] <= 0.0f;
        lse[i] = dead ? FB_NEG_INF : m[i] + logf(l[i]);
        if (tx == 0 && qi < Sq) {
            lse_out[row_stat + qi] = lse[i];
            d_out[row_stat + qi] = Dr[i];
        }
    }

    // pass 2: dq = dS . k
    float acc[R][CPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BT;
        __syncthreads();
        fb_load_rows<HD>(sK, kp, s[5], k0, Skv);
        fb_load_rows<HD>(sV, vp, s[8], k0, Skv);
        __syncthreads();
        float sc[R][R], dp[R][R];
        fb_dot_tile<HD>(sQ, sK, sc, tx, ty);
        fb_dot_tile<HD>(sDO, sV, dp, tx, ty);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int qi = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int kj = k0 + tx + 16 * j;
                float x = sc[i][j] * scale, tc = 0.0f;
                if (softcap != 0.0f) {
                    tc = tanhf(x / softcap);
                    x = tc * softcap;
                }
                float ds = 0.0f;
                if (fb_unmasked(qi, kj, Skv, causal, window)) {
                    const float p = expf(x - lse[i]);
                    ds = p * (dp[i][j] - Dr[i]);
                    if (softcap != 0.0f) ds *= 1.0f - tc * tc;
                }
                sS[(ty + 16 * i) * PS + tx + 16 * j] = ds;
            }
        }
        __syncthreads();                    // the dS tile is complete
#pragma unroll 4
        for (int kk = 0; kk < BT; ++kk) {
            float dsv[R], kv[CPT];
#pragma unroll
            for (int i = 0; i < R; ++i) dsv[i] = sS[(ty + 16 * i) * PS + kk];
#pragma unroll
            for (int c = 0; c < CPT; ++c) kv[c] = sK[kk * LD + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
                for (int c = 0; c < CPT; ++c)
                    acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int qi = q0 + ty + 16 * i;
        if (qi < Sq) {
            T* row = dqp + (long long)qi * s[17];
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                fb_st(row + tx + 16 * c, acc[i][c] * scale);
        }
    }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t fb_dkdv_smem_floats() {
    using Tl = FbTile<HD>;
    return (size_t)4 * Tl::B * Tl::LD + (size_t)2 * Tl::B * Tl::PS;
}

template <int HD, typename T>
__global__ void __launch_bounds__(FB_THREADS)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse_in,
                   const float* __restrict__ d_in, T* __restrict__ dk,
                   T* __restrict__ dv, int H, int G, int Sq, int Skv,
                   FbStrides st, int causal, int window, float scale,
                   float softcap) {
    using Tl = FbTile<HD>;
    constexpr int BT = Tl::B, R = Tl::R, LD = Tl::LD, PS = Tl::PS;
    constexpr int CPT = Tl::CPT;
    extern __shared__ float4 fb_smem4[];
    float* sK = reinterpret_cast<float*>(fb_smem4);     // BT x LD
    float* sV = sK + BT * LD;                           // BT x LD
    float* sQ = sV + BT * LD;                           // BT x LD
    float* sDO = sQ + BT * LD;                          // BT x LD
    float* sP = sDO + BT * LD;                          // BT x PS
    float* sS = sP + BT * PS;                           // BT x PS (dS)
    __shared__ float sL[64], sD[64];

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
    const long long* s = st.s;
    const T* kp = k + b * s[3] + kvh * s[4];
    const T* vp = v + b * s[6] + kvh * s[7];

    fb_load_rows<HD>(sK, kp, s[5], k0, Skv);
    fb_load_rows<HD>(sV, vp, s[8], k0, Skv);

    // the query rows that see one of this tile's keys: the band, and every
    // row past it when some rows see no key at all (they average every key)
    const int k_last = min(k0 + BT, Skv) - 1;
    int q_begin = causal ? k0 : 0;
    int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
    if (window > 0 && Sq > Skv + window - 1) q_end = Sq;
    if (q_begin >= q_end) q_begin = q_end;
    const int qt_begin = q_begin / BT;
    const int qt_end = q_end > q_begin ? (q_end - 1) / BT + 1 : qt_begin;
    const float inv_skv = 1.0f / (float)Skv;

    float ak[R][CPT], av[R][CPT];           // dk, dv rows ty + 16 i
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            ak[i][c] = 0.0f;
            av[i][c] = 0.0f;
        }

    for (int gi = 0; gi < G; ++gi) {
        const int h = kvh * G + gi;
        const T* qp = q + b * s[0] + h * s[1];
        const T* dop = dout + b * s[12] + h * s[13];
        const long long row_stat = ((long long)b * H + h) * Sq;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
            const int q0 = qt * BT;
            __syncthreads();                // the last tile's reads done
            fb_load_rows<HD>(sQ, qp, s[2], q0, Sq);
            fb_load_rows<HD>(sDO, dop, s[14], q0, Sq);
            if (tid < BT) {
                const int qi = q0 + tid;
                sL[tid] = qi < Sq ? lse_in[row_stat + qi] : 0.0f;
                sD[tid] = qi < Sq ? d_in[row_stat + qi] : 0.0f;
            }
            __syncthreads();
            // rows: queries ty + 16 i; columns: keys tx + 16 j
            float sc[R][R], dp[R][R];
            fb_dot_tile<HD>(sQ, sK, sc, tx, ty);
            fb_dot_tile<HD>(sDO, sV, dp, tx, ty);
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const int r = ty + 16 * i, qi = q0 + r;
                const bool dead = qi < Sq && fb_dead(qi, Skv, window);
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    const int kj = k0 + tx + 16 * j;
                    float x = sc[i][j] * scale, tc = 0.0f;
                    if (softcap != 0.0f) {
                        tc = tanhf(x / softcap);
                        x = tc * softcap;
                    }
                    float p = 0.0f, ds = 0.0f;
                    if (qi < Sq && fb_unmasked(qi, kj, Skv, causal, window)) {
                        p = expf(x - sL[r]);
                        ds = p * (dp[i][j] - sD[r]);
                        if (softcap != 0.0f) ds *= 1.0f - tc * tc;
                    } else if (dead && kj < Skv) {
                        p = inv_skv;
                    }
                    sP[r * PS + tx + 16 * j] = p;
                    sS[r * PS + tx + 16 * j] = ds;
                }
            }
            __syncthreads();                // P and dS complete
            // dv[key][c] += P[q][key] dout[q][c]; dk += dS[q][key] q[q][c]
#pragma unroll 2
            for (int qq = 0; qq < BT; ++qq) {
                float pv[R], sv[R], dov[CPT], qv[CPT];
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    pv[i] = sP[qq * PS + ty + 16 * i];
                    sv[i] = sS[qq * PS + ty + 16 * i];
                }
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    dov[c] = sDO[qq * LD + tx + 16 * c];
                    qv[c] = sQ[qq * LD + tx + 16 * c];
                }
#pragma unroll
                for (int i = 0; i < R; ++i)
#pragma unroll
                    for (int c = 0; c < CPT; ++c) {
                        av[i][c] = fmaf(pv[i], dov[c], av[i][c]);
                        ak[i][c] = fmaf(sv[i], qv[c], ak[i][c]);
                    }
            }
        }
    }
    T* dkp = dk + b * s[18] + kvh * s[19];
    T* dvp = dv + b * s[21] + kvh * s[22];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int kj = k0 + ty + 16 * i;
        if (kj < Skv) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                fb_st(dkp + (long long)kj * s[20] + tx + 16 * c,
                      ak[i][c] * scale);
                fb_st(dvp + (long long)kj * s[23] + tx + 16 * c, av[i][c]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, typename T>
static int fb_launch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, float* lse, float* dd, int B, int H, int KV,
                     int Sq, int Skv, const FbStrides& st, int causal,
                     int window, float scale, float softcap,
                     cudaStream_t stream) {
    using Tl = FbTile<HD>;
    const size_t smem_dq = sizeof(float) * fb_dq_smem_floats<HD>();
    const size_t smem_kv = sizeof(float) * fb_dkdv_smem_floats<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_dq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        fa_bwd_dkdv_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return (int)err;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    dim3 g1((Sq + Tl::B - 1) / Tl::B, H, B);
    fa_bwd_dq_kernel<HD, T><<<g1, FB_THREADS, smem_dq, stream>>>(
        tq, tk, tv, static_cast<const T*>(o), static_cast<const T*>(dout),
        static_cast<T*>(dq), lse, dd, H, H / KV, Sq, Skv, st, causal, window,
        scale, softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 g2((Skv + Tl::B - 1) / Tl::B, KV, B);
    fa_bwd_dkdv_kernel<HD, T><<<g2, FB_THREADS, smem_kv, stream>>>(
        tq, tk, tv, static_cast<const T*>(dout), lse, dd,
        static_cast<T*>(dk), static_cast<T*>(dv), H, H / KV, Sq, Skv, st,
        causal, window, scale, softcap);
    return (int)cudaGetLastError();
}

template <typename T>
static int fb_dispatch(int hd, const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* dd, int B, int H, int KV,
                       int Sq, int Skv, const FbStrides& st, int causal,
                       int window, float scale, float softcap,
                       cudaStream_t s) {
#define FB_CASE(n)                                                           \
    case n:                                                                  \
        return fb_launch<n, T>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H,  \
                               KV, Sq, Skv, st, causal, window, scale,       \
                               softcap, s);
    switch (hd) {
        FB_CASE(16) FB_CASE(32) FB_CASE(64) FB_CASE(128) FB_CASE(256)
    default: return (int)cudaErrorInvalidValue;
    }
#undef FB_CASE
}

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// strides: 24 element strides, (batch, head, sequence) of q, k, v, o,
// dout, dq, dk and dv in that order; the head dimension is contiguous.
// lse and dd: (B, H, Sq) float32 scratch, written by the first kernel and
// read by the second.
extern "C" int flash_attention_bwd_launch(
        const void* q, const void* k, const void* v, const void* o,
        const void* dout, void* dq, void* dk, void* dv, float* lse,
        float* dd, int B, int H, int KV, int Sq, int Skv, int hd, int dtype,
        const long long* strides, int causal, int window, float scale,
        float softcap, void* stream) {
    if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1
            || B > 65535 || H > 65535 || window < 0)
        return (int)cudaErrorInvalidValue;
    FbStrides st;
    for (int i = 0; i < 24; ++i) st.s[i] = strides[i];
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return fb_dispatch<float>(hd, q, k, v, o, dout, dq, dk, dv, lse, dd,
                                  B, H, KV, Sq, Skv, st, causal, window,
                                  scale, softcap, s);
    if (dtype == 1)
        return fb_dispatch<bf16>(hd, q, k, v, o, dout, dq, dk, dv, lse, dd,
                                 B, H, KV, Sq, Skv, st, causal, window,
                                 scale, softcap, s);
    return (int)cudaErrorInvalidValue;
}
