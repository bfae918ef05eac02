// Streaming-softmax (flash) attention for Hopper (sm_90a): GQA, causal and
// sliding-window masks, tanh logit softcap, any Sq and Skv.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel), whose sequential kv grid axis carries a
// running max, a running sum and an f32 accumulator in VMEM scratch.  Here
// one block owns one (batch, q-head, 64-query tile) and a loop inside the
// block walks the key tiles, the state kept in registers.  Computes what
// the plain version (kernels/ref.py mha_reference) computes:
//   s = (q . k) * scale ; s = tanh(s / cap) * cap   (cap != 0)
//   s = NEG_INF where masked (key past Skv; key > query if causal; key <=
//       query - window if window)
//   o = softmax(s) @ v, kv head = q head / (H / KV)
//
// Two instances, chosen by dtype (kernels/flash_attention.py plan()); the
// bf16 instance's helpers (cp.async, ldmatrix, mma.sync, the fragment
// layout) live in mma_bf16.cuh, shared with the backward:
//
// * bfloat16, "mma_bf16": the tensor cores.  Four warps, each owning 16
//   query rows.  S = Q.K^T runs as mma.sync.m16n8k16 (bf16 in, f32
//   accumulate) with Q and K fragments read from shared memory by
//   ldmatrix; the online softmax runs on the accumulator fragments in
//   registers (exp2f, log2(e) folded into the scale); P is rounded to
//   bf16 in registers and fed back as the A operand of O += P.V, with V
//   read by ldmatrix.trans, so P never touches shared memory.  K and V
//   tiles arrive by 16-byte cp.async into a two-stage ring: the loads of
//   tile i+1 are in flight while tile i computes, one __syncthreads per
//   tile.  Shared-memory rows are padded by 16 bytes, which makes every
//   ldmatrix free of bank conflicts at every head dim.  Masks are
//   evaluated only on edge tiles (ragged Skv, the causal diagonal, the
//   window's lower edge); interior tiles of the band skip them.  P is
//   rounded to bf16 before P.V, as the model's own attention does; the
//   plain version keeps it in f32 (tolerance 2e-2 in bf16).  The output
//   tile is staged in the warp's own Q rows and stored 16 bytes a thread.
//   Needs 16-byte aligned rows: base addresses and batch, head and
//   sequence strides multiples of 8 elements (the wrapper checks).
//
// * float32, "simt_f32": the CUDA cores.  TF32 tensor cores keep about
//   three digits and the f32 checks hold 2e-5, so float32 stays on f32
//   FMAs: 256 threads, Q.K^T as a 4x4 register tile per thread over float4
//   shared-memory reads, P through shared memory, P.V as a 4 x hd/16 tile.
//
// Layout: both take element strides for the batch, head and sequence
// dimensions of each tensor (the head dimension must be contiguous), so
// the model hands its (B, S, H, hd) activations over as (B, H, S, hd)
// views without a transposing copy.
//
// Masking follows the TPU kernel exactly: a masked score is NEG_INF, not
// -inf, and p = exp(s - m).  A row that has seen only masked keys has
// m = NEG_INF and takes p = 1 for them; the first unmasked key raises m and
// alpha = exp(NEG_INF - m) = 0 wipes that.  A row with no unmasked key at
// all ends as the plain version's uniform average over every key (keys
// past Skv take p = 0, so they are not counted in that average).  A block
// visits only the key tiles that hold an unmasked key for some row of its
// query tile (the causal/window band): at S = 1,536 with window 1,024 that
// skips more than half of the tiles; a query tile with a row that has no
// unmasked key (window with Sq > Skv + window - 1) visits every tile.
//
// What bounds it on the card: at hymba-1.5b's prefill (B=4, H=25, KV=5,
// S=1,536, hd=64, window 1,024, bf16) the unmasked (q, k) pairs take
// 26.9 GFLOP, about 27 us at the bf16 tensor-core peak, and 104.9 M
// exponentials, about the same time on the special-function units
// (16 per SM per clock); the 47 MB it must move take about 14 us.
// mma.sync reaches a fraction of the tensor-core peak that only wgmma
// fed by TMA, with a producer warp and setmaxnreg (the FA3 shape), can
// pass; that is the next step for this kernel.  At hd 64 the launch bound
// of four blocks an SM caps the registers at 128 and ptxas spills 32
// bytes; a build for three blocks an SM, timed on the card while this
// bound was chosen, needs no spill and was slower.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

#define FA_NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;

struct FaStrides {
    long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// The key tiles [*kt_begin, *kt_end) of width bk that a query tile
// [q0, q0 + bq) must visit: the causal/window band, or every tile when a
// row of the tile has no unmasked key.
__device__ __forceinline__ void fa_tile_range(int q0, int bq, int bk, int Sq,
                                              int Skv, int causal, int window,
                                              int* kt_begin, int* kt_end) {
    const int q_last = min(q0 + bq, Sq) - 1;
    int k_begin = 0, k_end = Skv;
    const bool empty_row = window > 0 && q_last > Skv + window - 2;
    if (!empty_row) {
        if (window > 0) k_begin = max(0, q0 - window + 1);
        if (causal) k_end = min(Skv, q_last + 1);
    }
    *kt_begin = k_begin / bk;
    *kt_end = k_end > k_begin ? (k_end - 1) / bk + 1 : *kt_begin;
}

// ---------------------------------------------------------------------------
// float32 instance: CUDA cores
// ---------------------------------------------------------------------------

#define FA_THREADS 256
#define FA_BQ 64
#define FA_BK 64

template <int HD>
constexpr size_t fa_smem_bytes() {
    return sizeof(float) * ((size_t)FA_BQ * (HD + 4) + (size_t)FA_BK * (HD + 4)
                            + (size_t)FA_BK * HD
                            + (size_t)FA_BQ * (FA_BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
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
    const float* qp = q + b * st.qb + h * st.qh;
    const float* kp = k + b * st.kb + kvh * st.kh;
    const float* vp = v + b * st.vb + kvh * st.vh;
    float* op = o + b * st.ob + h * st.oh;

    for (int e = tid; e < FA_BQ * HD; e += FA_THREADS) {
        const int r = e / HD, d = e % HD, qi = q0 + r;
        sQ[r * QS + d] = qi < Sq ? qp[(long long)qi * st.qs + d] : 0.0f;
    }

    int kt_begin, kt_end;
    fa_tile_range(q0, FA_BQ, FA_BK, Sq, Skv, causal, window, &kt_begin,
                  &kt_end);

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
            sK[r * QS + d] = ok ? kp[(long long)kj * st.ks + d] : 0.0f;
            sV[r * HD + d] = ok ? vp[(long long)kj * st.vs + d] : 0.0f;
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
            float* orow = op + (long long)qi * st.os;
#pragma unroll
            for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[i][c] / den;
        }
    }
}

// ---------------------------------------------------------------------------
// bfloat16 instance: tensor cores (mma.sync), cp.async double buffer
// ---------------------------------------------------------------------------

#define TC_THREADS 128                  // four warps
#define TC_BQ 64                        // 16 query rows per warp

template <int HD>
struct TcTile {
    static constexpr int BK = HD >= 256 ? 32 : 64;  // keys per tile
    static constexpr int LD = HD + 8;       // padded smem row, elements
    static constexpr int CH = HD / 8;       // 16-byte chunks per row
    // blocks an SM should hold: at hd 64 four blocks of 46 KB shared
    // memory, so at most 128 registers a thread
    static constexpr int MIN_BLOCKS = HD <= 64 ? 4
                                      : HD <= 128 ? 2 : 1;
    static constexpr size_t SMEM =
        sizeof(bf16) * (size_t)LD * (TC_BQ + 4 * BK);  // Q, 2 x (K, V)
};

// Fragment layout of mma.m16n8k16 (lane = 4 g + t): the accumulator c[e]
// holds row g + 8 (e / 2), column 2 t + (e % 2) of its 16x8 tile; the A
// operand a0..a3 holds rows g / g+8, columns 2t..2t+1 / 8+2t..9+2t.  So
// the score tiles 2kk and 2kk+1, rounded to bf16, are the A operand of the
// kk-th 16-key step of P.V without leaving the registers.
//
// qk_scale: scale * log2(e) without softcap, scale / cap with it; cap_l2:
// 0 without softcap, cap * log2(e) with it.  Scores live in the log2
// domain, so p = exp2(s - m).
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, TcTile<HD>::MIN_BLOCKS)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int G, int Sq, int Skv, FaStrides st, int causal,
                            int window, float qk_scale, float cap_l2) {
    using Tile = TcTile<HD>;
    constexpr int BK = Tile::BK, LD = Tile::LD, CH = Tile::CH;
    constexpr int NT = BK / 8;          // score tiles (8 keys) per warp row
    constexpr int DT = HD / 8;          // output tiles (8 dims) per warp row
    extern __shared__ float4 tc_smem4[];
    bf16* sQ = reinterpret_cast<bf16*>(tc_smem4);       // BQ x LD
    bf16* sK = sQ + TC_BQ * LD;                         // 2 x BK x LD
    bf16* sV = sK + 2 * BK * LD;                        // 2 x BK x LD

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int q0 = blockIdx.x * TC_BQ;
    const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
    const bf16* qp = q + b * st.qb + h * st.qh;
    const bf16* kp = k + b * st.kb + kvh * st.kh;
    const bf16* vp = v + b * st.vb + kvh * st.vh;
    bf16* op = o + b * st.ob + h * st.oh;

    int kt_begin, kt_end;
    fa_tile_range(q0, TC_BQ, BK, Sq, Skv, causal, window, &kt_begin,
                  &kt_end);
    const int n_tiles = kt_end - kt_begin;

    // Q with the first K/V tile in one group
    for (int e = tid; e < TC_BQ * CH; e += TC_THREADS) {
        const int r = e / CH, c = e % CH, qi = q0 + r;
        const bool ok = qi < Sq;
        cp_async16(smem_u32(sQ + r * LD + c * 8),
                   qp + (long long)(ok ? qi : 0) * st.qs + c * 8, ok);
    }
    auto load_kv = [&](int kt, int stage) {
        const int k0 = kt * BK;
        bf16* dk = sK + stage * BK * LD;
        bf16* dv = sV + stage * BK * LD;
        for (int e = tid; e < BK * CH; e += TC_THREADS) {
            const int r = e / CH, c = e % CH, kj = k0 + r;
            const bool ok = kj < Skv;
            const long long row = ok ? kj : 0;
            cp_async16(smem_u32(dk + r * LD + c * 8), kp + row * st.ks + c * 8,
                       ok);
            cp_async16(smem_u32(dv + r * LD + c * 8), vp + row * st.vs + c * 8,
                       ok);
        }
    };
    if (n_tiles > 0) load_kv(kt_begin, 0);
    cp_async_commit();

    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;
    float m_r[2] = {FA_NEG_INF, FA_NEG_INF}, l_r[2] = {0.0f, 0.0f};
    const int row_lo = q0 + warp * 16 + g;          // rows row_lo, row_lo + 8
    const uint32_t q_addr =
        smem_u32(sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
    const int k_row = (lane & 7) + ((lane >> 4) << 3);      // ldmatrix rows
    const int k_col = ((lane >> 3) & 1) * 8;
    const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_col = (lane >> 4) * 8;

    for (int i = 0; i < n_tiles; ++i) {
        // tile i has landed (every thread's copies) and every warp is done
        // with tile i-1, whose stage the next load overwrites
        cp_async_wait_all();
        __syncthreads();
        if (i + 1 < n_tiles) {
            load_kv(kt_begin + i + 1, (i + 1) & 1);
            cp_async_commit();
        }

        const int stage = i & 1;
        const bf16* tK = sK + stage * BK * LD;
        const bf16* tV = sV + stage * BK * LD;
        const int k0 = (kt_begin + i) * BK;

        // S = Q . K^T
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t a0, a1, a2, a3;
            ldsm_x4(a0, a1, a2, a3, q_addr + kk * 32);
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                uint32_t b0, b1, b2, b3;
                ldsm_x4(b0, b1, b2, b3,
                        smem_u32(tK + (j * 8 + k_row) * LD + kk * 16 + k_col));
                mma_bf16(s[j], a0, a1, a2, a3, b0, b1);
                mma_bf16(s[j + 1], a0, a1, a2, a3, b2, b3);
            }
        }

        // scale, softcap, masks (edge tiles only), running max
        const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q0)
                          || (window > 0 && k0 <= q0 + TC_BQ - 1 - window);
        float mx[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * qk_scale;
                if (cap_l2 != 0.0f) x = tanhf(x) * cap_l2;
                if (edge) {
                    const int qi = row_lo + (e >> 1) * 8;
                    const int kj = k0 + j * 8 + tq * 2 + (e & 1);
                    bool ok = kj < Skv;
                    if (causal) ok = ok && kj <= qi;
                    if (window > 0) ok = ok && kj > qi - window;
                    if (!ok) x = FA_NEG_INF;
                }
                s[j][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_r[r], mx[r]);
            alpha[r] = exp2f(m_r[r] - m_new);
            m_r[r] = m_new;
        }
        // p = exp2(s - m); keys past Skv do not exist (p = 0), so a row
        // with no unmasked key averages the real keys only.  l sums this
        // thread's columns; the quad's sum is taken once, at the end.
        float rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float p = exp2f(s[j][e] - m_r[e >> 1]);
                if (edge && k0 + j * 8 + tq * 2 + (e & 1) >= Skv) p = 0.0f;
                s[j][e] = p;
                rs[e >> 1] += p;
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
        for (int d = 0; d < DT; ++d) {
            acc[d][0] *= alpha[0];
            acc[d][1] *= alpha[0];
            acc[d][2] *= alpha[1];
            acc[d][3] *= alpha[1];
        }

        // O += P . V, P from registers
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int d = 0; d < DT; d += 2) {
                uint32_t b0, b1, b2, b3;
                ldsm_x4_t(b0, b1, b2, b3,
                          smem_u32(tV + (kk * 16 + v_row) * LD + d * 8
                                   + v_col));
                mma_bf16(acc[d], a0, a1, a2, a3, b0, b1);
                mma_bf16(acc[d + 1], a0, a1, a2, a3, b2, b3);
            }
        }
    }
    cp_async_wait_all();                // nothing left in flight, and
    __syncthreads();                    // every thread's Q copies landed

    // normalise; stage the warp's 16 rows in its own Q rows (no other warp
    // reads them), then store 16 bytes a thread
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_r[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.0f / fmaxf(l, 1e-30f);
    }
    bf16* sO = sQ + warp * 16 * LD;
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DT; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(sO + g * LD + d * 8 + tq * 2) =
            __floats2bfloat162_rn(acc[d][0] * inv[0], acc[d][1] * inv[0]);
        *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8) * LD + d * 8
                                           + tq * 2) =
            __floats2bfloat162_rn(acc[d][2] * inv[1], acc[d][3] * inv[1]);
    }
    __syncwarp();
    for (int e = lane; e < 16 * CH; e += 32) {
        const int r = e / CH, c = e % CH, qi = q0 + warp * 16 + r;
        if (qi < Sq)
            *reinterpret_cast<uint4*>(op + (long long)qi * st.os + c * 8) =
                *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
static int fa_launch_f32(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int KV, int Sq, int Skv,
                         const FaStrides& st, int causal, int window,
                         float scale, float softcap, cudaStream_t stream) {
    const size_t smem = fa_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
    flash_attention_f32_kernel<HD><<<grid, FA_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H / KV, Sq,
        Skv, st, causal, window, scale, softcap);
    return (int)cudaGetLastError();
}

template <int HD>
static int fa_launch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int H, int KV, int Sq, int Skv,
                          const FaStrides& st, int causal, int window,
                          float scale, float softcap, cudaStream_t stream) {
    const float log2e = 1.4426950408889634f;
    const float qk_scale = softcap != 0.0f ? scale / softcap : scale * log2e;
    const float cap_l2 = softcap != 0.0f ? softcap * log2e : 0.0f;
    const size_t smem = TcTile<HD>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
    flash_attention_bf16_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), H / KV, Sq, Skv,
        st, causal, window, qk_scale, cap_l2);
    return (int)cudaGetLastError();
}

#define FA_DISPATCH(fn)                                                      \
    switch (hd) {                                                            \
    case 16: return fn<16>(q, k, v, o, B, H, KV, Sq, Skv, st, causal,       \
                           window, scale, softcap, s);                       \
    case 32: return fn<32>(q, k, v, o, B, H, KV, Sq, Skv, st, causal,       \
                           window, scale, softcap, s);                       \
    case 64: return fn<64>(q, k, v, o, B, H, KV, Sq, Skv, st, causal,       \
                           window, scale, softcap, s);                       \
    case 128: return fn<128>(q, k, v, o, B, H, KV, Sq, Skv, st, causal,     \
                             window, scale, softcap, s);                     \
    case 256: return fn<256>(q, k, v, o, B, H, KV, Sq, Skv, st, causal,     \
                             window, scale, softcap, s);                     \
    default: return (int)cudaErrorInvalidValue;                              \
    }

static bool fa_aligned16(const void* p, const long long* strides) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
    for (int i = 0; i < 3; ++i)
        if (strides[i] % 8) return false;
    return true;
}

// dtype: 0 float32 (CUDA-core instance), 1 bfloat16 (tensor-core
// instance).  strides: 12 element strides, (batch, head, sequence) of q,
// k, v and o in that order.
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
    if (dtype == 0) {
        FA_DISPATCH(fa_launch_f32)
    }
    if (dtype == 1) {
        if (!fa_aligned16(q, strides) || !fa_aligned16(k, strides + 3)
                || !fa_aligned16(v, strides + 6)
                || !fa_aligned16(o, strides + 9))
            return (int)cudaErrorMisalignedAddress;
        FA_DISPATCH(fa_launch_bf16)
    }
    return (int)cudaErrorInvalidValue;
}
