// The gradient of the selective-SSM scan (ssm_scan.cu) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel (its
// training gradient is autodiff of the lax.scan in
// src/repro/models/ssm.py mamba_mixer).  The port's train-mode forward
// runs the hand-written scan, so its gradient needs one too.  Computes
// what the plain version (kernels/ref.py ssm_scan_backward_reference)
// computes, in float32, with g_t the gradient of the state h_t:
//   g_{S-1} = dh_final (0 when absent) ; going back in time:
//   g_t    += dy_t C_t                     (then carried: g_{t-1} starts
//                                            as exp(dt_t A) g_t)
//   dC_t    = sum_d dy_t h_t               dB_t = sum_d g_t dt_t x_t
//   dx_t    = dt_t sum_n g_t B_t
//   ddt_t   = x_t sum_n g_t B_t + sum_n g_t h_{t-1} A exp(dt_t A)
//   dA      = sum_{b, t} g_t h_{t-1} dt_t exp(dt_t A)
//
// Design.  h_{t-1} and h_t are recomputed: every state at hymba-1.5b's
// training shape (B=4, S=4,096, Dss=3,200, N=16) would take 3.4 GB a
// layer.  Each thread owns E = 4 state elements n*E .. n*E+3 of one
// (batch, channel), G = N / 4 lanes a channel (rounded up to a power of
// two), so a block of 128 threads owns 128 / G channels of one batch row:
// 32 at N = 16.  Pass 1 runs the forward recurrence and writes the state
// before every SB_T = 16th step to global memory (210 MB at that shape);
// pass 2 walks the segments from the last, reloads a segment's checkpoint,
// recomputes its 16 states into shared memory with the forward's roundings
// (__fmul_rn/__fadd_rn, expf: the same states), then runs the reverse
// recurrence over them.  The reverse step's chain is two instructions an
// element (g += dy C, g *= exp(dt A)); exp(dt A) there is the fast ex2
// (two instructions, about 1e-7 relative) rather than a third accurate
// expf, and every load of the step is independent of g.  The segments'
// inputs are fetched into registers one segment ahead and stored to shared
// memory at the segment's start, so their latency overlaps the compute.
//
// Fixed-order sums, no atomics: two calls give the same bits.
// * dx and ddt sum over the state: a reduce-scatter over the channel's G
//   lanes (xor shuffles, a fixed tree) after each step, the two sums kept
//   in shared memory and written after the segment, coalesced by channel.
// * dB and dC sum over the channels: each step's 2E partials are
//   reduce-scattered over the warp's 32 / G channels (7 shuffles a lane at
//   N = 16), kept per warp in shared memory, and after the segment summed
//   over the block's four warps in warp order into a per-block partial,
//   (2, B, channel groups, S, N) float32 scratch: 100 groups of 32
//   channels, 210 MB at hymba's shape.
// * dA sums over batch and time: registers over time, then (B, Dss, N)
//   scratch.
// A second kernel on the stream, ssm_scan_bwd_sum, adds the partials in
// group (and batch) order into dB, dC and dA, writing every element, so
// nothing is zeroed first.
//
// Occupancy: 55,808 bytes of shared memory and at most 128 registers a
// thread (__launch_bounds__(128, 4)), so four blocks (16 warps) fit an SM.
// At hymba's shape the grid is 100 x 4 = 400 blocks, one wave of the 528
// slots of 132 SMs (four SMs hold four blocks, the rest three); PR 25's
// kernel held two blocks an SM and ran 800 blocks as three full waves and
// a fourth of eight blocks.
//
// What bounds it on the card: at hymba-1.5b's training shape it must read
// dt, x, dy, B and C and write ddt, dx, dB and dC (about 1.05 GB, 0.31 ms
// at 3.35 TB/s); its exponentials (two accurate ones and a fast one per
// state element and step) and about 45 instructions per element and step
// over 839 M element-steps keep it above that.  The serial chains over
// 4,096 steps remain: a time-chunked scan whose segments run in parallel
// (a carry pass for g between chunks), and the forward writing the
// checkpoints in train mode so that pass 1 goes, are what is left.

#include <cuda_runtime.h>
#include <stdint.h>

#define SB_THREADS 128
#define SB_T 16                 // steps per checkpointed segment
#define SB_TP (SB_T + 1)        // padded staging row of one channel

// shared floats of one block (kernels/ssm_scan.py backward_geometry
// repeats this): the segment's states, its staged inputs, the warps'
// dB/dC partials and the dx/ddt sums
template <int G, int E>
constexpr size_t sb_smem_floats() {
    constexpr int CPB = SB_THREADS / G, NP = G * E;
    return (size_t)(SB_T + 1) * SB_THREADS * E       // states of a segment
           + (size_t)3 * CPB * SB_TP                 // dt, x, dy
           + (size_t)2 * SB_T * NP                   // B, C
           + (size_t)(SB_THREADS / 32) * SB_T * 2 * NP   // dB, dC a warp
           + (size_t)2 * SB_T * (CPB + 1);           // sums over the state
}

// Sums each of v[0..LEN) over the lanes that differ from this one in the
// lane bits OFF, 2 OFF, ... below END, as a reduce-scatter: each level
// halves the values a lane holds (the half picked by the level's bit) and
// adds the partner's other half; once one value is left, the remaining
// levels add it whole.  base: the index of v[0] among the original values.
template <int LEN, int OFF, int END, int V>
__device__ __forceinline__ void sb_reduce(float (&v)[V], int lane,
                                          int& base) {
    if constexpr (OFF < END) {
        if constexpr (LEN > 1) {
            constexpr int HALF = LEN / 2;
            const bool up = (lane & OFF) != 0;
#pragma unroll
            for (int i = 0; i < HALF; ++i) {
                const float send = up ? v[i] : v[i + HALF];
                const float keep = up ? v[i + HALF] : v[i];
                v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
            }
            if (up) base += HALF;
            sb_reduce<HALF, OFF * 2, END>(v, lane, base);
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
            sb_reduce<1, OFF * 2, END>(v, lane, base);
        }
    }
}

// E consecutive floats of shared memory (16-, 8- or 4-byte aligned)
template <int E>
__device__ __forceinline__ void sb_ld(float (&v)[E], const float* p) {
    if constexpr (E == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else if constexpr (E == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x; v[1] = t.y;
    } else {
        v[0] = p[0];
    }
}

template <int E>
__device__ __forceinline__ void sb_st(float* p, const float (&v)[E]) {
    if constexpr (E == 4)
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else if constexpr (E == 2)
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    else
        p[0] = v[0];
}

// values a lane holds after sb_reduce of V values over W lanes
__host__ __device__ constexpr int sb_kept(int V, int W) {
    return V > W ? V / W : 1;
}

template <int G, int E>
__global__ void __launch_bounds__(SB_THREADS, 4)
ssm_scan_bwd_kernel(const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ x,
                    const float* __restrict__ A,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh,
                    float* __restrict__ ckpt, float* __restrict__ ddt,
                    float* __restrict__ dx, float* __restrict__ part,
                    float* __restrict__ part_dA, int S, int Dss, int N) {
    constexpr int CPB = SB_THREADS / G, NP = G * E;
    constexpr int W = 32 / G, V = 2 * E;            // channels a warp
    constexpr int NW = SB_THREADS / 32, GS = CPB + 1;
    extern __shared__ float4 sb_smem4[];
    float* sH = reinterpret_cast<float*>(sb_smem4);  // [T+1][THREADS][E]
    float* sDt = sH + (SB_T + 1) * SB_THREADS * E;   // [CPB][TP]
    float* sX = sDt + CPB * SB_TP;                   // [CPB][TP]
    float* sDy = sX + CPB * SB_TP;                   // [CPB][TP]
    float* sB = sDy + CPB * SB_TP;                   // [T][NP]
    float* sC = sB + SB_T * NP;                      // [T][NP]
    float* sRed = sC + SB_T * NP;                    // [NW][T][2][NP]
    float* sGs = sRed + NW * SB_T * 2 * NP;          // [2][T][GS]

    const int tid = threadIdx.x, c = tid / G, n = tid % G;
    const int lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y, grp = blockIdx.x, ngrp = gridDim.x;
    const int d0 = grp * CPB, d = d0 + c;
    const bool live = d < Dss;
    const long long row0 = (long long)b * S;
    const int nseg = (S + SB_T - 1) / SB_T;

    float a[E], h[E], g[E], dAacc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int nn = n * E + j;
        const bool ok = live && nn < N;
        a[j] = ok ? A[(long long)d * N + nn] : 0.0f;
        h[j] = 0.0f;
        g[j] = (ok && dh) ? dh[((long long)b * Dss + d) * N + nn] : 0.0f;
        dAacc[j] = 0.0f;
    }

    // A segment's inputs, this thread's slots: fetched into registers one
    // segment ahead, stored to shared memory at the segment's start.
    // Steps past S, channels past Dss and states past N read as 0, which
    // makes a padded step the identity (exp(0) = 1, no input).
    constexpr int DXS = (SB_T * CPB + SB_THREADS - 1) / SB_THREADS;
    constexpr int BCS = (SB_T * NP + SB_THREADS - 1) / SB_THREADS;
    float f_dt[DXS], f_x[DXS], f_dy[DXS], f_b[BCS], f_c[BCS];
    auto fetch = [&](int t0, bool with_dy) {
#pragma unroll
        for (int i = 0; i < DXS; ++i) {
            const int e = tid + i * SB_THREADS, k = e / CPB, cc = e % CPB;
            const bool ok = e < SB_T * CPB && t0 + k < S && d0 + cc < Dss;
            const long long gi = ok ? (row0 + t0 + k) * Dss + d0 + cc : 0;
            f_dt[i] = ok ? dt[gi] : 0.0f;
            f_x[i] = ok ? x[gi] : 0.0f;
            f_dy[i] = (ok && with_dy) ? dy[gi] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < BCS; ++i) {
            const int e = tid + i * SB_THREADS, k = e / NP, nn = e % NP;
            const bool ok = e < SB_T * NP && t0 + k < S && nn < N;
            const long long gi = ok ? (row0 + t0 + k) * N + nn : 0;
            f_b[i] = ok ? Bm[gi] : 0.0f;
            f_c[i] = (ok && with_dy) ? Cm[gi] : 0.0f;
        }
    };
    auto commit = [&]() {
        __syncthreads();                    // the last segment's reads done
#pragma unroll
        for (int i = 0; i < DXS; ++i) {
            const int e = tid + i * SB_THREADS, k = e / CPB, cc = e % CPB;
            if (e < SB_T * CPB) {
                sDt[cc * SB_TP + k] = f_dt[i];
                sX[cc * SB_TP + k] = f_x[i];
                sDy[cc * SB_TP + k] = f_dy[i];
            }
        }
#pragma unroll
        for (int i = 0; i < BCS; ++i) {
            const int e = tid + i * SB_THREADS;
            if (e < SB_T * NP) {
                sB[e] = f_b[i];
                sC[e] = f_c[i];
            }
        }
        __syncthreads();
    };
    // one forward step k of the staged segment, the forward's roundings
    auto fwd = [&](int k) {
        const float dtv = sDt[c * SB_TP + k], xv = sX[c * SB_TP + k];
        const float u = __fmul_rn(dtv, xv);
        float bv[E];
        sb_ld<E>(bv, sB + k * NP + n * E);
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const float da = expf(__fmul_rn(dtv, a[j]));
            h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(u, bv[j]));
        }
    };

    // pass 1: the forward recurrence, the state before each segment saved
    float* ck = ckpt + (long long)b * nseg * Dss * N;
    fetch(0, nseg == 1);
    for (int sg = 0; sg < nseg; ++sg) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int nn = n * E + j;
            if (live && nn < N) ck[((long long)sg * Dss + d) * N + nn] = h[j];
        }
        if (sg == nseg - 1) break;          // the last segment's states are
        commit();                           // recomputed in pass 2
        fetch((sg + 1) * SB_T, sg + 1 == nseg - 1);
#pragma unroll
        for (int k = 0; k < SB_T; ++k) fwd(k);
    }

    // pass 2: the segments from the last, each recomputed, then reversed
    float* pB = part + (((long long)b * ngrp + grp) * S) * N;
    float* pC = pB + (long long)gridDim.y * ngrp * S * N;
    for (int sg = nseg - 1; sg >= 0; --sg) {
        const int t0 = sg * SB_T;
        commit();
        if (sg > 0) fetch(t0 - SB_T, true);
        float* hs = sH + tid * E;
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int nn = n * E + j;
            h[j] = (live && nn < N) ? ck[((long long)sg * Dss + d) * N + nn]
                                    : 0.0f;
        }
        sb_st<E>(hs, h);
#pragma unroll
        for (int k = 0; k < SB_T; ++k) {
            fwd(k);
            sb_st<E>(hs + (k + 1) * SB_THREADS * E, h);
        }
#pragma unroll
        for (int k = SB_T - 1; k >= 0; --k) {
            const float dtv = sDt[c * SB_TP + k], xv = sX[c * SB_TP + k];
            const float dyv = sDy[c * SB_TP + k];
            const float u = dtv * xv;
            float gs[2] = {0.0f, 0.0f}, pv[V];
            float bv[E], cv[E], hp[E], hc[E];
            sb_ld<E>(bv, sB + k * NP + n * E);
            sb_ld<E>(cv, sC + k * NP + n * E);
            sb_ld<E>(hp, hs + k * SB_THREADS * E);
            sb_ld<E>(hc, hs + (k + 1) * SB_THREADS * E);
#pragma unroll
            for (int j = 0; j < E; ++j) {
                const float da = __expf(dtv * a[j]);
                g[j] = fmaf(dyv, cv[j], g[j]);
                const float ghd = g[j] * hp[j] * da;
                gs[0] = fmaf(g[j], bv[j], gs[0]);
                gs[1] = fmaf(ghd, a[j], gs[1]);
                dAacc[j] = fmaf(ghd, dtv, dAacc[j]);
                pv[j] = g[j] * u;
                pv[E + j] = dyv * hc[j];
                g[j] *= da;
            }
            // sums over the state: the channel's G lanes; lane n < 2 keeps
            // sum n (0: g.B, 1: g h dA A)
            int gbase = 0;
            sb_reduce<2, 1, G>(gs, lane, gbase);
            if (n < (G < 2 ? G : 2)) {
#pragma unroll
                for (int i = 0; i < sb_kept(2, G); ++i)
                    sGs[((gbase + i) * SB_T + k) * GS + c] = gs[i];
            }
            // sums over the warp's channels; value i of lane (c, n) is
            // pv[i]: dB (i < E) or dC of state n * E + i % E
            int pbase = 0;
            sb_reduce<V, G, 32>(pv, lane, pbase);
            if ((lane / G) < (V < W ? V : W)) {
#pragma unroll
                for (int i = 0; i < sb_kept(V, W); ++i) {
                    const int vi = pbase + i;
                    sRed[((warp * SB_T + k) * 2 + vi / E) * NP + n * E
                         + vi % E] = pv[i];
                }
            }
        }
        __syncthreads();                    // the segment's sums are complete
        for (int e = tid; e < SB_T * CPB; e += SB_THREADS) {
            const int k = e / CPB, cc = e % CPB;
            if (t0 + k < S && d0 + cc < Dss) {
                const float gbv = sGs[k * GS + cc];
                const float ghv = sGs[(SB_T + k) * GS + cc];
                const long long gi = (row0 + t0 + k) * Dss + d0 + cc;
                dx[gi] = sDt[cc * SB_TP + k] * gbv;
                ddt[gi] = fmaf(sX[cc * SB_TP + k], gbv, ghv);
            }
        }
        for (int e = tid; e < SB_T * 2 * NP; e += SB_THREADS) {
            const int k = e / (2 * NP), arr = (e / NP) % 2, nn = e % NP;
            if (t0 + k < S && nn < N) {
                float acc = 0.0f;
#pragma unroll
                for (int w = 0; w < NW; ++w)
                    acc += sRed[((w * SB_T + k) * 2 + arr) * NP + nn];
                (arr ? pC : pB)[(long long)(t0 + k) * N + nn] = acc;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int nn = n * E + j;
        if (live && nn < N)
            part_dA[((long long)b * Dss + d) * N + nn] = dAacc[j];
    }
}

// dB, dC: the per-group partials summed in group order; dA: the per-batch
// partials summed in batch order.  Writes every element of the three.
__global__ void __launch_bounds__(256)
ssm_scan_bwd_sum_kernel(const float* __restrict__ part,
                        const float* __restrict__ part_dA,
                        float* __restrict__ dBm, float* __restrict__ dCm,
                        float* __restrict__ dA, int B, int S, int Dss, int N,
                        int ngrp) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long SN = (long long)S * N, BSN = B * SN;
    if (i < 2 * BSN) {
        const long long arr = i / BSN, r = i % BSN, b = r / SN, tn = r % SN;
        const float* p = part + ((arr * B + b) * ngrp) * SN + tn;
        float acc = 0.0f;
        for (int k = 0; k < ngrp; ++k) acc += p[k * SN];
        (arr ? dCm : dBm)[r] = acc;
    } else if (i < 2 * BSN + (long long)Dss * N) {
        const long long r = i - 2 * BSN, DN = (long long)Dss * N;
        float acc = 0.0f;
        for (int b = 0; b < B; ++b) acc += part_dA[b * DN + r];
        dA[r] = acc;
    }
}

template <int G, int E>
static int sb_launch(const float* dt, const float* Bm, const float* Cm,
                     const float* x, const float* A, const float* dy,
                     const float* dh, float* ckpt, float* part,
                     float* part_dA, float* ddt, float* dBm, float* dCm,
                     float* dx, float* dA, int B, int S, int Dss, int N,
                     cudaStream_t s) {
    constexpr int CPB = SB_THREADS / G;
    const size_t smem = sizeof(float) * sb_smem_floats<G, E>();
    cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<G, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int ngrp = (Dss + CPB - 1) / CPB;
    dim3 grid(ngrp, B);
    ssm_scan_bwd_kernel<G, E><<<grid, SB_THREADS, smem, s>>>(
        dt, Bm, Cm, x, A, dy, dh, ckpt, ddt, dx, part, part_dA, S, Dss, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = 2LL * B * S * N + (long long)Dss * N;
    ssm_scan_bwd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        part, part_dA, dBm, dCm, dA, B, S, Dss, N, ngrp);
    return (int)cudaGetLastError();
}

// All arrays float32 and contiguous: dt/x/dy/ddt/dx (B, S, Dss), Bm/Cm/
// dBm/dCm (B, S, N), A/dA (Dss, N), dh (B, Dss, N) or null (no gradient
// of the final state).  Scratch: ckpt (B, ceil(S / 16), Dss, N), part
// (2, B, ceil(Dss / (128 / lanes)), S, N), part_dA (B, Dss, N).  lanes,
// elems: the backward's split of kernels/ssm_scan.py backward_lanes().
// dBm, dCm and dA are written whole by the second kernel.
extern "C" int ssm_scan_bwd_launch(const float* dt, const float* Bm,
                                   const float* Cm, const float* x,
                                   const float* A, const float* dy,
                                   const float* dh, float* ckpt, float* part,
                                   float* part_dA, float* ddt, float* dBm,
                                   float* dCm, float* dx, float* dA, int B,
                                   int S, int Dss, int N, int lanes,
                                   int elems, void* stream) {
    if (B < 1 || B > 65535 || S < 1 || Dss < 1 || N < 1 || N > 64
            || lanes < 1 || elems < 1 || lanes * elems < N)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define SB_CASE(g, e)                                                        \
    if (lanes == g && elems == e)                                            \
        return sb_launch<g, e>(dt, Bm, Cm, x, A, dy, dh, ckpt, part,         \
                               part_dA, ddt, dBm, dCm, dx, dA, B, S, Dss, N, \
                               s);
    SB_CASE(1, 1) SB_CASE(1, 2) SB_CASE(1, 4) SB_CASE(2, 4) SB_CASE(4, 4)
    SB_CASE(8, 4) SB_CASE(16, 4)
#undef SB_CASE
    return (int)cudaErrorInvalidValue;
}
