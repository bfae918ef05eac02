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
// Two instances, chosen by kernels/flash_attention.py plan_backward(); both
// are two kernels on the stream with no atomics, so a call gives the same
// bits every time.  The first kernel writes each row's log-sum-exp and
// D = rowsum(dout * out) to (B, H, Sq) float32 scratch and accumulates dq;
// the second reads them and accumulates dk and dv.
//
// * bfloat16 at head dims 16-128, "mma_bf16": the tensor cores, in the
//   FA2 shape.  Blocks of four warps, 16 rows a warp.
//   - fa_bwd_dq_tc: one block per (batch, q head, 64-query tile).  Pass 1
//     walks the key tiles of the causal/window band with S = Q.K^T on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate; Q and K fragments by
//     ldmatrix) and an online max and sum in the log2 domain, which give
//     each row's log-sum-exp (the forward writes none, so serving's kernel
//     and its time stay as they are).  Pass 2 walks the same tiles again:
//     S and dP = dout.V^T on mma.sync, P = exp2(S log2(e) - lse) and
//     dS = P (dP - D) (times 1 - t^2 with a softcap) on the accumulator
//     fragments in registers, and dq += dS.K with dS rounded to bf16 in
//     registers as the A operand and K read by ldmatrix.trans.
//   - fa_bwd_dkdv_tc: one block per (batch, kv head, 64-key tile).  It
//     walks the G q heads of its group and the query tiles of the band
//     (plus the rows with no unmasked key) and forms S^T = K.Q^T and
//     dP^T = V.dout^T, then P^T from the saved lse and dS^T, and
//     accumulates dv += P^T.dout and dk += dS^T.Q, all on mma.sync with
//     P^T and dS^T as register A operands; dk and dv stay in registers,
//     summed over the group.  Query tiles are 32 rows (dk and dv take
//     hd / 2 registers each a thread, the score tiles 16).
//   Both: tiles arrive by 16-byte cp.async into a two-stage ring (pass 1
//   and pass 2 of the dq kernel are one sequence of tiles); shared-memory
//   rows are padded by 16 bytes, so ldmatrix has no bank conflicts; masks
//   are evaluated on edge tiles only (ragged lengths, the causal diagonal,
//   the window's lower edge, rows with no unmasked key); exponentials are
//   a bare ex2.approx.  P and dS are rounded to bf16 before their
//   products, as in the forward; the plain version keeps float32
//   (tolerance 2e-2 of each output's largest magnitude).  Needs 16-byte
//   aligned rows (base addresses and batch, head and sequence strides
//   multiples of 8 elements); the wrapper refuses a bf16 call that breaks
//   this.  The helpers are shared with the forward (mma_bf16.cuh).
//
// * float32, and bfloat16 at head dim 256, "simt_f32": the CUDA cores in
//   float32 (TF32 keeps about three digits and the f32 checks hold 1e-4;
//   at hd 256, dk and dv would take 128 registers each a thread on the
//   tensor-core design).  fa_bwd_dq recomputes the rows' statistics in a
//   first pass over the band, writes lse and D, then accumulates dq;
//   fa_bwd_dkdv walks the group's q heads and query tiles and sums dk and
//   dv in registers.  Each 256-thread block computes a 64 x 64 tile (32 x
//   32 at hd 256) of s and of dout.v^T as a 4 x 4 register tile a thread
//   over float4 reads of float32 shared memory; P and dS go through shared
//   memory.
//
// Strides are the caller's (the head dimension contiguous), so the model's
// (B, S, H, hd) activations and gradients arrive as (B, H, S, hd) views.
//
// What bounds it on the card: at hymba-1.5b's training shape (B=4, H=25,
// KV=5, S=4,096, hd 64, causal, window 1,024) the unmasked (q, k) pairs
// need five products of 2 hd flops each (q.k, dout.v, P^T.dout, dS^T.q,
// dS.k: 235 GFLOP, about 0.24 ms at the bf16 tensor-core peak) and an
// exponential each.  The tensor-core instance does eight products over
// whole band tiles (q.k in both passes of the dq kernel and again in the
// dk/dv kernel, dout.v in both kernels): about 376 GFLOP on mma.sync,
// and three exponentials a pair.  mma.sync issued by four warps a block
// reaches a fraction of the tensor-core peak; wgmma fed by TMA with a
// producer warp, and the forward writing lse so that the statistics pass
// goes, are what is left for a later design.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
// bfloat16 instance: tensor cores (mma.sync), cp.async double buffer
// ---------------------------------------------------------------------------

#define FT_THREADS 128                  // four warps
#define FT_BR 64                        // a block's rows: 16 a warp

template <int HD>
struct FtTile {
    static constexpr int LD = HD + 8;       // padded smem row, elements
    static constexpr int CH = HD / 8;       // 16-byte chunks per row
    static constexpr int BK = 64;           // keys a tile of the dq kernel
    // queries a tile of the dk/dv kernel: dk and dv hold HD / 2 registers
    // each a thread, the two score tiles BQ / 2 each
    static constexpr int BQ = 32;
    // blocks an SM each kernel is built for: at hd <= 64 three (at most 168
    // registers a thread, no spill); two at hd 128 (the accumulators)
    static constexpr int MIN_BLOCKS = HD <= 64 ? 3 : 2;
    // Q, dout, 2 x (K, V)
    static constexpr size_t DQ_SMEM =
        sizeof(bf16) * (size_t)LD * (2 * FT_BR + 4 * BK);
    // K, V, 2 x (Q, dout), 2 x (lse, D)
    static constexpr size_t DKV_SMEM =
        sizeof(bf16) * (size_t)LD * (2 * FT_BR + 4 * BQ)
        + sizeof(float) * 4 * BQ;
};

// 2^x on the special-function unit alone (ex2.approx.ftz, about 2 ulp;
// a result below the smallest normal float flushes to 0): exp2f adds the
// instructions that keep such results, which only masked or negligible
// probabilities reach
__device__ __forceinline__ float fb_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// 4 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// The key tiles [*kt_begin, *kt_end) of width bk that the query tile
// [q0, q0 + bq) visits: the causal/window band, or every tile when a row
// of the tile has no unmasked key (the forward's range).
__device__ __forceinline__ void fb_key_tiles(int q0, int bq, int bk, int Sq,
                                             int Skv, int causal, int window,
                                             int* kt_begin, int* kt_end) {
    const int q_last = min(q0 + bq, Sq) - 1;
    int k_begin = 0, k_end = Skv;
    if (!(window > 0 && q_last > Skv + window - 2)) {
        if (window > 0) k_begin = max(0, q0 - window + 1);
        if (causal) k_end = min(Skv, q_last + 1);
    }
    *kt_begin = k_begin / bk;
    *kt_end = k_end > k_begin ? (k_end - 1) / bk + 1 : *kt_begin;
}

// The query tiles [*qt_begin, *qt_end) of width bq that the key tile
// [k0, k0 + bk) visits: the band, and every row past it when some rows
// have no unmasked key (they average every key).
__device__ __forceinline__ void fb_query_tiles(int k0, int bk, int bq,
                                               int Sq, int Skv, int causal,
                                               int window, int* qt_begin,
                                               int* qt_end) {
    const int k_last = min(k0 + bk, Skv) - 1;
    int q_begin = causal ? k0 : 0;
    int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
    if (window > 0 && Sq > Skv + window - 1) q_end = Sq;
    if (q_begin >= q_end) q_begin = q_end;
    *qt_begin = q_begin / bq;
    *qt_end = q_end > q_begin ? (q_end - 1) / bq + 1 : *qt_begin;
}

// s[j] = A . B^T over the head dim for NT 8-column tiles: A the warp's 16
// rows at a_addr (ldmatrix), B rows [j * 8, j * 8 + 8) of the tile tB
// (row = output column, the head dim contiguous)
template <int HD, int NT>
__device__ __forceinline__ void ft_abt(float (&s)[NT][4], uint32_t a_addr,
                                       const bf16* tB, int b_row,
                                       int b_col) {
    constexpr int LD = FtTile<HD>::LD;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a0, a1, a2, a3;
        ldsm_x4(a0, a1, a2, a3, a_addr + kk * 32);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(b0, b1, b2, b3,
                    smem_u32(tB + (j * 8 + b_row) * LD + kk * 16 + b_col));
            mma_bf16(s[j], a0, a1, a2, a3, b0, b1);
            mma_bf16(s[j + 1], a0, a1, a2, a3, b2, b3);
        }
    }
}

// acc += P . B: P the NT accumulator tiles in registers, rounded to bf16
// (16 x 8 NT), B the tile tB of 8 NT rows by HD (ldmatrix.trans)
template <int HD, int NT>
__device__ __forceinline__ void ft_pb(float (&acc)[HD / 8][4],
                                      const float (&p)[NT][4],
                                      const bf16* tB, int v_row, int v_col) {
    constexpr int LD = FtTile<HD>::LD;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
        for (int d = 0; d < HD / 8; d += 2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(b0, b1, b2, b3,
                      smem_u32(tB + (kk * 16 + v_row) * LD + d * 8 + v_col));
            mma_bf16(acc[d], a0, a1, a2, a3, b0, b1);
            mma_bf16(acc[d + 1], a0, a1, a2, a3, b2, b3);
        }
    }
}

// Stores the warp's 16 x HD accumulator rows (times mul) as bf16: staged
// in the warp's own 16 rows of the shared tile sW, then 16 bytes a thread
// to the rows row0 + r < n of dst (row stride rs).
template <int HD>
__device__ __forceinline__ void ft_store_rows(const float (&acc)[HD / 8][4],
                                              float mul, bf16* sW,
                                              bf16* dst, long long rs,
                                              int row0, int n) {
    constexpr int LD = FtTile<HD>::LD, CH = FtTile<HD>::CH;
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
    __syncwarp();
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(sW + g * LD + d * 8 + tq * 2) =
            __floats2bfloat162_rn(acc[d][0] * mul, acc[d][1] * mul);
        *reinterpret_cast<__nv_bfloat162*>(sW + (g + 8) * LD + d * 8
                                           + tq * 2) =
            __floats2bfloat162_rn(acc[d][2] * mul, acc[d][3] * mul);
    }
    __syncwarp();
    for (int e = lane; e < 16 * CH; e += 32) {
        const int r = e / CH, c = e % CH, ri = row0 + r;
        if (ri < n)
            *reinterpret_cast<uint4*>(dst + (long long)ri * rs + c * 8) =
                *reinterpret_cast<const uint4*>(sW + r * LD + c * 8);
    }
}

// qk_scale: scale * log2(e) without softcap, scale / cap with it; cap_l2:
// 0 without softcap, cap * log2(e) with it.  Scores and lse live in the
// log2 domain, so p = exp2(s - lse).
template <int HD>
__global__ void __launch_bounds__(FT_THREADS, FtTile<HD>::MIN_BLOCKS)
fa_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ d_out,
                    int H, int G, int Sq, int Skv, FbStrides st, int causal,
                    int window, float qk_scale, float cap_l2, float scale) {
    using Tl = FtTile<HD>;
    constexpr int BK = Tl::BK, LD = Tl::LD, CH = Tl::CH;
    constexpr int NT = BK / 8, DT = HD / 8;
    extern __shared__ float4 ft_smem4[];
    bf16* sQ = reinterpret_cast<bf16*>(ft_smem4);       // BR x LD
    bf16* sDO = sQ + FT_BR * LD;                        // BR x LD
    bf16* sK = sDO + FT_BR * LD;                        // 2 x BK x LD
    bf16* sV = sK + 2 * BK * LD;                        // 2 x BK x LD

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int q0 = blockIdx.x * FT_BR, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / G;
    const long long* s = st.s;
    const bf16* qp = q + b * s[0] + h * s[1];
    const bf16* kp = k + b * s[3] + kvh * s[4];
    const bf16* vp = v + b * s[6] + kvh * s[7];
    const bf16* op = o + b * s[9] + h * s[10];
    const bf16* dop = dout + b * s[12] + h * s[13];
    const long long row_stat = ((long long)b * H + h) * Sq;

    int kt_begin, kt_end;
    fb_key_tiles(q0, FT_BR, BK, Sq, Skv, causal, window, &kt_begin, &kt_end);
    const int n_tiles = kt_end - kt_begin;

    // Q and dout with the first K tile in one group
    for (int e = tid; e < FT_BR * CH; e += FT_THREADS) {
        const int r = e / CH, c = e % CH, qi = q0 + r;
        const bool ok = qi < Sq;
        const long long row = ok ? qi : 0;
        cp_async16(smem_u32(sQ + r * LD + c * 8), qp + row * s[2] + c * 8,
                   ok);
        cp_async16(smem_u32(sDO + r * LD + c * 8), dop + row * s[14] + c * 8,
                   ok);
    }
    // tile i of the sequence: pass 1 (i < n_tiles) reads K, pass 2 K and V
    auto load = [&](int i, int stage) {
        const bool with_v = i >= n_tiles;
        const int k0 = (kt_begin + (with_v ? i - n_tiles : i)) * BK;
        bf16* dk = sK + stage * BK * LD;
        bf16* dv = sV + stage * BK * LD;
        for (int e = tid; e < BK * CH; e += FT_THREADS) {
            const int r = e / CH, c = e % CH, kj = k0 + r;
            const bool ok = kj < Skv;
            const long long row = ok ? kj : 0;
            cp_async16(smem_u32(dk + r * LD + c * 8), kp + row * s[5] + c * 8,
                       ok);
            if (with_v)
                cp_async16(smem_u32(dv + r * LD + c * 8),
                           vp + row * s[8] + c * 8, ok);
        }
    };
    if (n_tiles > 0) load(0, 0);
    cp_async_commit();

    // D = rowsum(dout * out) of the warp's 16 rows, from global memory
    // while the first copies are in flight; this thread keeps rows g, g + 8
    float Dr[2] = {0.0f, 0.0f};
    for (int r = 0; r < 16; ++r) {
        const int qi = q0 + warp * 16 + r;
        float acc = 0.0f;
        if (qi < Sq) {
            const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(
                dop + (long long)qi * s[14]);
            const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(
                op + (long long)qi * s[11]);
            for (int d = lane; d < HD / 2; d += 32) {
                const float2 x = __bfloat1622float2(a[d]);
                const float2 y = __bfloat1622float2(c[d]);
                acc = fmaf(x.x, y.x, acc);
                acc = fmaf(x.y, y.y, acc);
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (r == g) Dr[0] = acc;
        if (r == g + 8) Dr[1] = acc;
    }

    const int row_lo = q0 + warp * 16 + g;          // rows row_lo, row_lo + 8
    const int a_off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
    const uint32_t q_addr = smem_u32(sQ + a_off);
    const uint32_t do_addr = smem_u32(sDO + a_off);
    const int k_row = (lane & 7) + ((lane >> 4) << 3);      // ldmatrix rows
    const int k_col = ((lane >> 3) & 1) * 8;
    const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_col = (lane >> 4) * 8;

    float m_r[2] = {FB_NEG_INF, FB_NEG_INF}, l_r[2] = {0.0f, 0.0f};
    float lse[2] = {FB_NEG_INF, FB_NEG_INF};
    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;

    // each row's log-sum-exp from pass 1's running max and sums; a row
    // with no unmasked key gets NEG_INF (pass 2 masks all its scores)
    auto finish_stats = [&]() {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float l = l_r[r];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            const int qi = row_lo + 8 * r;
            const bool dead = fb_dead(qi, Skv, window) || l <= 0.0f;
            lse[r] = dead ? FB_NEG_INF : m_r[r] + log2f(l);
            if (tq == 0 && qi < Sq) {
                lse_out[row_stat + qi] = lse[r];
                d_out[row_stat + qi] = Dr[r];
            }
        }
    };

    for (int i = 0; i < 2 * n_tiles; ++i) {
        // tile i has landed (every thread's copies) and every warp is done
        // with tile i-1, whose stage the next load overwrites
        cp_async_wait_all();
        __syncthreads();
        if (i + 1 < 2 * n_tiles) {
            load(i + 1, (i + 1) & 1);
            cp_async_commit();
        }
        const bool pass2 = i >= n_tiles;
        if (i == n_tiles) finish_stats();
        const int stage = i & 1;
        const bf16* tK = sK + stage * BK * LD;
        const int k0 = (kt_begin + (pass2 ? i - n_tiles : i)) * BK;
        const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q0)
                          || (window > 0 && k0 <= q0 + FT_BR - 1 - window);

        float sc[NT][4];
        ft_abt<HD, NT>(sc, q_addr, tK, k_row, k_col);      // S = Q . K^T
        if (!pass2) {
            // scale, softcap, masks (edge tiles only), running max and sum
            float mx[2] = {FB_NEG_INF, FB_NEG_INF};
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = sc[j][e] * qk_scale;
                    if (cap_l2 != 0.0f) x = tanhf(x) * cap_l2;
                    if (edge) {
                        const int qi = row_lo + (e >> 1) * 8;
                        const int kj = k0 + j * 8 + tq * 2 + (e & 1);
                        if (!fb_unmasked(qi, kj, Skv, causal, window))
                            x = FB_NEG_INF;
                    }
                    sc[j][e] = x;
                    mx[e >> 1] = fmaxf(mx[e >> 1], x);
                }
            float alpha[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m_r[r], mx[r]);
                alpha[r] = fb_exp2(m_r[r] - m_new);
                m_r[r] = m_new;
            }
            float rs[2] = {0.0f, 0.0f};
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float p = fb_exp2(sc[j][e] - m_r[e >> 1]);
                    if (edge && k0 + j * 8 + tq * 2 + (e & 1) >= Skv) p = 0.0f;
                    rs[e >> 1] += p;
                }
#pragma unroll
            for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
            continue;
        }
        // pass 2: dP = dout . V^T, dS = P (dP - D), dq += dS . K
        float dp[NT][4];
        ft_abt<HD, NT>(dp, do_addr, sV + stage * BK * LD, k_row, k_col);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = sc[j][e] * qk_scale, tc = 0.0f;
                if (cap_l2 != 0.0f) {
                    tc = tanhf(x);
                    x = tc * cap_l2;
                }
                float p = fb_exp2(x - lse[e >> 1]);
                if (edge) {
                    const int qi = row_lo + (e >> 1) * 8;
                    const int kj = k0 + j * 8 + tq * 2 + (e & 1);
                    if (!fb_unmasked(qi, kj, Skv, causal, window)) p = 0.0f;
                }
                float ds = p * (dp[j][e] - Dr[e >> 1]);
                if (cap_l2 != 0.0f) ds *= 1.0f - tc * tc;
                sc[j][e] = ds;
            }
        ft_pb<HD, NT>(acc, sc, tK, v_row, v_col);
    }
    if (n_tiles == 0) finish_stats();
    // every thread's Q copies have landed before a warp stages its rows
    cp_async_wait_all();
    __syncthreads();
    ft_store_rows<HD>(acc, scale, sQ + warp * 16 * LD,
                      dq + b * s[15] + h * s[16], s[17], q0 + warp * 16, Sq);
}

template <int HD>
__global__ void __launch_bounds__(FT_THREADS, FtTile<HD>::MIN_BLOCKS)
fa_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse_in,
                      const float* __restrict__ d_in, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int G, int Sq, int Skv,
                      FbStrides st, int causal, int window, float qk_scale,
                      float cap_l2, float scale) {
    using Tl = FtTile<HD>;
    constexpr int BQ = Tl::BQ, LD = Tl::LD, CH = Tl::CH;
    constexpr int NT = BQ / 8, DT = HD / 8;
    extern __shared__ float4 ft_smem4[];
    bf16* sK = reinterpret_cast<bf16*>(ft_smem4);       // BR x LD
    bf16* sV = sK + FT_BR * LD;                         // BR x LD
    bf16* sQ = sV + FT_BR * LD;                         // 2 x BQ x LD
    bf16* sDO = sQ + 2 * BQ * LD;                       // 2 x BQ x LD
    float* sL = reinterpret_cast<float*>(sDO + 2 * BQ * LD);  // 2 x BQ
    float* sD = sL + 2 * BQ;                                  // 2 x BQ

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int k0 = blockIdx.x * FT_BR, kvh = blockIdx.y, b = blockIdx.z;
    const long long* s = st.s;
    const bf16* kp = k + b * s[3] + kvh * s[4];
    const bf16* vp = v + b * s[6] + kvh * s[7];

    for (int e = tid; e < FT_BR * CH; e += FT_THREADS) {
        const int r = e / CH, c = e % CH, kj = k0 + r;
        const bool ok = kj < Skv;
        const long long row = ok ? kj : 0;
        cp_async16(smem_u32(sK + r * LD + c * 8), kp + row * s[5] + c * 8,
                   ok);
        cp_async16(smem_u32(sV + r * LD + c * 8), vp + row * s[8] + c * 8,
                   ok);
    }
    int qt_begin, qt_end;
    fb_query_tiles(k0, FT_BR, BQ, Sq, Skv, causal, window, &qt_begin,
                   &qt_end);
    const int nq = qt_end - qt_begin, n_tiles = G * nq;
    // tile i: q head kvh * G + i / nq, query tile qt_begin + i % nq
    auto load = [&](int i, int stage) {
        const int h = kvh * G + i / nq, q0 = (qt_begin + i % nq) * BQ;
        const bf16* qp = q + b * s[0] + h * s[1];
        const bf16* dop = dout + b * s[12] + h * s[13];
        bf16* tq_ = sQ + stage * BQ * LD;
        bf16* tdo = sDO + stage * BQ * LD;
        for (int e = tid; e < BQ * CH; e += FT_THREADS) {
            const int r = e / CH, c = e % CH, qi = q0 + r;
            const bool ok = qi < Sq;
            const long long row = ok ? qi : 0;
            cp_async16(smem_u32(tq_ + r * LD + c * 8), qp + row * s[2] + c * 8,
                       ok);
            cp_async16(smem_u32(tdo + r * LD + c * 8),
                       dop + row * s[14] + c * 8, ok);
        }
        if (tid < 2 * BQ) {
            const int r = tid % BQ, qi = q0 + r;
            const bool ok = qi < Sq;
            const float* src = (tid < BQ ? lse_in : d_in)
                               + ((long long)b * H + h) * Sq + (ok ? qi : 0);
            cp_async4z(smem_u32((tid < BQ ? sL : sD) + stage * BQ + r), src,
                       ok);
        }
    };
    if (n_tiles > 0) load(0, 0);
    cp_async_commit();

    const int a_off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
    const uint32_t k_addr = smem_u32(sK + a_off);
    const uint32_t v_addr = smem_u32(sV + a_off);
    const int b_row = (lane & 7) + ((lane >> 4) << 3);      // ldmatrix rows
    const int b_col = ((lane >> 3) & 1) * 8;
    const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int t_col = (lane >> 4) * 8;
    const int key_lo = k0 + warp * 16 + g;          // keys key_lo, key_lo + 8
    const float inv_skv = 1.0f / (float)Skv;

    float ak[DT][4], av[DT][4];             // dk, dv of the warp's 16 keys
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            ak[d][e] = 0.0f;
            av[d][e] = 0.0f;
        }

    for (int i = 0; i < n_tiles; ++i) {
        cp_async_wait_all();
        __syncthreads();
        if (i + 1 < n_tiles) {
            load(i + 1, (i + 1) & 1);
            cp_async_commit();
        }
        const int stage = i & 1;
        const bf16* tQ = sQ + stage * BQ * LD;
        const bf16* tDO = sDO + stage * BQ * LD;
        const float* tL = sL + stage * BQ;
        const float* tD = sD + stage * BQ;
        const int q0 = (qt_begin + i % nq) * BQ;
        const bool edge = q0 + BQ > Sq || k0 + FT_BR > Skv
                          || (causal && k0 + FT_BR - 1 > q0)
                          || (window > 0 && (k0 <= q0 + BQ - 1 - window
                                             || q0 + BQ > Skv + window - 1));

        // rows: the warp's keys; columns: the tile's queries
        float sc[NT][4], dp[NT][4];
        ft_abt<HD, NT>(sc, k_addr, tQ, b_row, b_col);      // S^T = K . Q^T
        ft_abt<HD, NT>(dp, v_addr, tDO, b_row, b_col);     // dP^T = V . dout^T
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int col = j * 8 + tq * 2;
            const float2 lv = *reinterpret_cast<const float2*>(tL + col);
            const float2 dv2 = *reinterpret_cast<const float2*>(tD + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float l = (e & 1) ? lv.y : lv.x;
                const float dd = (e & 1) ? dv2.y : dv2.x;
                float x = sc[j][e] * qk_scale, tc = 0.0f;
                if (cap_l2 != 0.0f) {
                    tc = tanhf(x);
                    x = tc * cap_l2;
                }
                float p = 0.0f, ds = 0.0f;
                bool live = true;
                if (edge) {
                    const int qi = q0 + col + (e & 1);
                    const int kj = key_lo + (e >> 1) * 8;
                    live = qi < Sq
                           && fb_unmasked(qi, kj, Skv, causal, window);
                    if (!live && qi < Sq && kj < Skv
                            && fb_dead(qi, Skv, window))
                        p = inv_skv;
                }
                if (live) {
                    p = fb_exp2(x - l);
                    ds = p * (dp[j][e] - dd);
                    if (cap_l2 != 0.0f) ds *= 1.0f - tc * tc;
                }
                sc[j][e] = p;
                dp[j][e] = ds;
            }
        }
        ft_pb<HD, NT>(av, sc, tDO, t_row, t_col);          // dv += P^T . dout
        ft_pb<HD, NT>(ak, dp, tQ, t_row, t_col);           // dk += dS^T . q
    }
    // every thread's K/V copies have landed before a warp stages its
    // outputs in those rows (a block with no query tile never waited)
    cp_async_wait_all();
    __syncthreads();
    ft_store_rows<HD>(ak, scale, sK + warp * 16 * LD,
                      dk + b * s[18] + kvh * s[19], s[20], k0 + warp * 16,
                      Skv);
    ft_store_rows<HD>(av, 1.0f, sV + warp * 16 * LD,
                      dv + b * s[21] + kvh * s[22], s[23], k0 + warp * 16,
                      Skv);
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

template <int HD>
static int ft_launch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, float* lse, float* dd, int B, int H, int KV,
                     int Sq, int Skv, const FbStrides& st, int causal,
                     int window, float scale, float softcap,
                     cudaStream_t stream) {
    using Tl = FtTile<HD>;
    const float log2e = 1.4426950408889634f;
    const float qk_scale = softcap != 0.0f ? scale / softcap : scale * log2e;
    const float cap_l2 = softcap != 0.0f ? softcap * log2e : 0.0f;
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Tl::DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        fa_bwd_dkdv_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::DKV_SMEM);
    if (err != cudaSuccess) return (int)err;
    const bf16* tq = static_cast<const bf16*>(q);
    const bf16* tk = static_cast<const bf16*>(k);
    const bf16* tv = static_cast<const bf16*>(v);
    const bf16* tdo = static_cast<const bf16*>(dout);
    dim3 g1((Sq + FT_BR - 1) / FT_BR, H, B);
    fa_bwd_dq_tc_kernel<HD><<<g1, FT_THREADS, Tl::DQ_SMEM, stream>>>(
        tq, tk, tv, static_cast<const bf16*>(o), tdo, static_cast<bf16*>(dq),
        lse, dd, H, H / KV, Sq, Skv, st, causal, window, qk_scale, cap_l2,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 g2((Skv + FT_BR - 1) / FT_BR, KV, B);
    fa_bwd_dkdv_tc_kernel<HD><<<g2, FT_THREADS, Tl::DKV_SMEM, stream>>>(
        tq, tk, tv, tdo, lse, dd, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, H / KV, Sq, Skv, st, causal, window,
        qk_scale, cap_l2, scale);
    return (int)cudaGetLastError();
}

static bool fb_aligned16(const void* p, const long long* strides) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
    for (int i = 0; i < 3; ++i)
        if (strides[i] % 8) return false;
    return true;
}

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// instance: 0 the CUDA-core kernels ("simt_f32", either dtype, head dims
// 16-256), 1 the tensor-core kernels ("mma_bf16", bfloat16, head dims
// 16-128, 16-byte aligned rows).  strides: 24 element strides, (batch,
// head, sequence) of q, k, v, o, dout, dq, dk and dv in that order; the
// head dimension is contiguous.  lse and dd: (B, H, Sq) float32 scratch,
// written by the first kernel and read by the second.
extern "C" int flash_attention_bwd_launch(
        const void* q, const void* k, const void* v, const void* o,
        const void* dout, void* dq, void* dk, void* dv, float* lse,
        float* dd, int B, int H, int KV, int Sq, int Skv, int hd, int dtype,
        int instance, const long long* strides, int causal, int window,
        float scale, float softcap, void* stream) {
    if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1
            || B > 65535 || H > 65535 || window < 0)
        return (int)cudaErrorInvalidValue;
    FbStrides st;
    for (int i = 0; i < 24; ++i) st.s[i] = strides[i];
    cudaStream_t s = (cudaStream_t)stream;
    if (instance == 1) {
        if (dtype != 1) return (int)cudaErrorInvalidValue;
        const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
        for (int i = 0; i < 8; ++i)
            if (!fb_aligned16(ptrs[i], strides + 3 * i))
                return (int)cudaErrorMisalignedAddress;
#define FT_CASE(n)                                                           \
        case n:                                                              \
            return ft_launch<n>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, \
                                KV, Sq, Skv, st, causal, window, scale,      \
                                softcap, s);
        switch (hd) {
            FT_CASE(16) FT_CASE(32) FT_CASE(64) FT_CASE(128)
        default: return (int)cudaErrorInvalidValue;
        }
#undef FT_CASE
    }
    if (instance != 0) return (int)cudaErrorInvalidValue;
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
