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
// h_{t-1} and h_t are recomputed: storing every state at hymba-1.5b's
// training shape (B=4, S=4,096, Dss=3,200, N=16) would take 3.4 GB a
// layer.  A first pass runs the forward recurrence and writes the state
// before every T_CK-th step to global memory (53 MB at that shape); the
// backward pass then walks the segments from the last: it reloads a
// segment's checkpoint, recomputes its T_CK states into shared memory
// (the forward's roundings, so the same states), and runs the reverse
// recurrence over them.  Three recurrences in all; each block owns its
// (batch, channels) for the whole sequence, so nothing crosses blocks
// except the sums below.
//
// Layout as the forward's: a group of G lanes owns one (batch, channel),
// each lane E = 2 state elements (1 at N = 1), a block of 128 threads owns
// 128 / G channels of one batch row.  Each segment's dt, x, dy, B and C
// are staged in shared memory by coalesced loads.  Reductions:
// * dx and ddt are sums over the state: xor-shuffles within the G lanes;
// * dB and dC are sums over the Dss channels: xor-shuffles over the
//   channels of a warp, shared-memory float atomics over the block's
//   warps, then one global float atomic per (step, state element) and
//   block after each segment (200 blocks add into each element at
//   hymba's width);
// * dA is a sum over batch and time: registers over time, one global
//   float atomic per element and batch row at the end.
// Float atomics add in an order that changes from run to run, so dB, dC
// and dA differ from the plain version, and from run to run, in their
// last bits: card against plain is held by tolerance.
//
// What bounds it on the card: at hymba-1.5b's training shape it must read
// dt, x, dy, B and C and write ddt, dx, dB and dC (about 1.1 GB, 0.33 ms
// at 3.35 TB/s) and take three exponentials per state element and step
// (3.1 G, about 0.75 ms on the special-function units), the larger; the
// serial recurrences over 4,096 steps with about 20 dependent
// instructions a step in the backward pass are what this simple design
// waits on.

#include <cuda_runtime.h>
#include <stdint.h>

#define SB_THREADS 128
#define SB_T 64                 // steps per checkpointed segment
#define SB_TP (SB_T + 1)        // padded staging row of one channel

template <int G, int E>
constexpr size_t sb_smem_floats() {
    constexpr int CPB = SB_THREADS / G, NP = G * E;
    return (size_t)(SB_T + 1) * E * SB_THREADS    // states of a segment
           + (size_t)3 * CPB * SB_TP             // dt, x, dy
           + (size_t)2 * SB_T * NP               // B, C
           + (size_t)2 * SB_T * NP;              // dB, dC block sums
}

template <int G, int E>
__global__ void __launch_bounds__(SB_THREADS)
ssm_scan_bwd_kernel(const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ x,
                    const float* __restrict__ A,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh,
                    float* __restrict__ ckpt, float* __restrict__ ddt,
                    float* __restrict__ dBm, float* __restrict__ dCm,
                    float* __restrict__ dx, float* __restrict__ dA, int S,
                    int Dss, int N) {
    constexpr int CPB = SB_THREADS / G, NP = G * E;
    extern __shared__ float4 sb_smem4[];
    float* sH = reinterpret_cast<float*>(sb_smem4);  // [T+1][E][THREADS]
    float* sDt = sH + (SB_T + 1) * E * SB_THREADS;   // [CPB][TP]
    float* sX = sDt + CPB * SB_TP;                   // [CPB][TP]
    float* sDy = sX + CPB * SB_TP;                   // [CPB][TP]
    float* sB = sDy + CPB * SB_TP;                   // [T][NP]
    float* sC = sB + SB_T * NP;                      // [T][NP]
    float* sdB = sC + SB_T * NP;                     // [T][NP]
    float* sdC = sdB + SB_T * NP;                    // [T][NP]

    const int tid = threadIdx.x, c = tid / G, n = tid % G, lane = tid & 31;
    const int b = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + c;
    const bool live = d < Dss;
    const long long row0 = (long long)b * S;
    const int nseg = (S + SB_T - 1) / SB_T;

    float a[E], h[E], g[E], dAacc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int nn = n + j * G;
        const bool ok = live && nn < N;
        a[j] = ok ? A[(long long)d * N + nn] : 0.0f;
        h[j] = 0.0f;
        g[j] = (ok && dh) ? dh[((long long)b * Dss + d) * N + nn] : 0.0f;
        dAacc[j] = 0.0f;
    }
    for (int e = tid; e < 2 * SB_T * NP; e += SB_THREADS) sdB[e] = 0.0f;

    // a segment's inputs into shared memory; rows past S, channels past
    // Dss and states past N read as 0
    auto stage = [&](int t0, bool with_dy) {
        const int T = min(SB_T, S - t0);
        __syncthreads();                    // the last segment's reads done
        for (int e = tid; e < SB_T * CPB; e += SB_THREADS) {
            const int t = e / CPB, cc = e % CPB;
            const bool ok = t < T && d0 + cc < Dss;
            const long long gi = (row0 + t0 + t) * Dss + d0 + cc;
            sDt[cc * SB_TP + t] = ok ? dt[gi] : 0.0f;
            sX[cc * SB_TP + t] = ok ? x[gi] : 0.0f;
            if (with_dy) sDy[cc * SB_TP + t] = ok ? dy[gi] : 0.0f;
        }
        for (int e = tid; e < SB_T * NP; e += SB_THREADS) {
            const int t = e / NP, nn = e % NP;
            const bool ok = t < T && nn < N;
            const long long gi = (row0 + t0 + t) * N + nn;
            sB[e] = ok ? Bm[gi] : 0.0f;
            if (with_dy) sC[e] = ok ? Cm[gi] : 0.0f;
        }
        __syncthreads();
    };
    // one forward step k of the staged segment, the forward's roundings
    auto fwd = [&](int k) {
        const float dtv = sDt[c * SB_TP + k], xv = sX[c * SB_TP + k];
        const float u = __fmul_rn(dtv, xv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const float da = expf(__fmul_rn(dtv, a[j]));
            h[j] = __fadd_rn(__fmul_rn(da, h[j]),
                             __fmul_rn(u, sB[k * NP + n + j * G]));
        }
    };

    // pass 1: the forward recurrence, the state before each segment saved
    float* ck = ckpt + (long long)b * nseg * Dss * N;
    for (int sg = 0; sg < nseg; ++sg) {
        const int t0 = sg * SB_T, T = min(SB_T, S - t0);
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int nn = n + j * G;
            if (live && nn < N)
                ck[((long long)sg * Dss + d) * N + nn] = h[j];
        }
        if (sg == nseg - 1) break;          // the last segment's states are
        stage(t0, false);                   // recomputed in pass 2
        for (int k = 0; k < T; ++k) fwd(k);
    }

    // pass 2: the segments from the last, each recomputed, then reversed
    for (int sg = nseg - 1; sg >= 0; --sg) {
        const int t0 = sg * SB_T, T = min(SB_T, S - t0);
        stage(t0, true);
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int nn = n + j * G;
            h[j] = (live && nn < N) ? ck[((long long)sg * Dss + d) * N + nn]
                                    : 0.0f;
            sH[j * SB_THREADS + tid] = h[j];
        }
        for (int k = 0; k < T; ++k) {
            fwd(k);
#pragma unroll
            for (int j = 0; j < E; ++j)
                sH[((k + 1) * E + j) * SB_THREADS + tid] = h[j];
        }
        for (int k = T - 1; k >= 0; --k) {
            const float dtv = sDt[c * SB_TP + k], xv = sX[c * SB_TP + k];
            const float dyv = sDy[c * SB_TP + k];
            const float u = __fmul_rn(dtv, xv);
            float gb = 0.0f, gh = 0.0f, pb[E], pc[E], da[E];
#pragma unroll
            for (int j = 0; j < E; ++j) {
                const int nn = n + j * G;
                const float bv = sB[k * NP + nn], cv = sC[k * NP + nn];
                const float hp = sH[(k * E + j) * SB_THREADS + tid];
                const float hc = sH[((k + 1) * E + j) * SB_THREADS + tid];
                g[j] = fmaf(dyv, cv, g[j]);
                da[j] = expf(__fmul_rn(dtv, a[j]));
                const float ghd = g[j] * hp * da[j];
                gb = fmaf(g[j], bv, gb);
                gh = fmaf(ghd, a[j], gh);
                dAacc[j] = fmaf(ghd, dtv, dAacc[j]);
                pb[j] = g[j] * u;
                pc[j] = dyv * hc;
            }
            // sums over the state: the channel's G lanes
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1) {
                gb += __shfl_xor_sync(0xffffffffu, gb, off);
                gh += __shfl_xor_sync(0xffffffffu, gh, off);
            }
            if (n == 0 && live) {
                const long long gi = (row0 + t0 + k) * Dss + d;
                dx[gi] = dtv * gb;
                ddt[gi] = fmaf(xv, gb, gh);
            }
            // sums over the channels: the warp's, then the block's
#pragma unroll
            for (int j = 0; j < E; ++j) {
#pragma unroll
                for (int off = G; off < 32; off <<= 1) {
                    pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], off);
                    pc[j] += __shfl_xor_sync(0xffffffffu, pc[j], off);
                }
                if (lane < G) {
                    atomicAdd(&sdB[k * NP + n + j * G], pb[j]);
                    atomicAdd(&sdC[k * NP + n + j * G], pc[j]);
                }
                g[j] *= da[j];
            }
        }
        __syncthreads();                    // the block's sums are complete
        for (int e = tid; e < T * NP; e += SB_THREADS) {
            const int k = e / NP, nn = e % NP;
            if (nn < N) {
                const long long gi = (row0 + t0 + k) * N + nn;
                atomicAdd(&dBm[gi], sdB[e]);
                atomicAdd(&dCm[gi], sdC[e]);
            }
            sdB[e] = 0.0f;
            sdC[e] = 0.0f;
        }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int nn = n + j * G;
        if (live && nn < N) atomicAdd(&dA[(long long)d * N + nn], dAacc[j]);
    }
}

template <int G, int E>
static int sb_launch(const float* dt, const float* Bm, const float* Cm,
                     const float* x, const float* A, const float* dy,
                     const float* dh, float* ckpt, float* ddt, float* dBm,
                     float* dCm, float* dx, float* dA, int B, int S, int Dss,
                     int N, cudaStream_t s) {
    constexpr int CPB = SB_THREADS / G;
    const size_t smem = sizeof(float) * sb_smem_floats<G, E>();
    cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<G, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Dss + CPB - 1) / CPB, B);
    ssm_scan_bwd_kernel<G, E><<<grid, SB_THREADS, smem, s>>>(
        dt, Bm, Cm, x, A, dy, dh, ckpt, ddt, dBm, dCm, dx, dA, S, Dss, N);
    return (int)cudaGetLastError();
}

// All arrays float32 and contiguous: dt/x/dy/ddt/dx (B, S, Dss), Bm/Cm/
// dBm/dCm (B, S, N), A/dA (Dss, N), dh (B, Dss, N) or null (no gradient
// of the final state), ckpt (B, ceil(S / 64), Dss, N) scratch.  dBm, dCm
// and dA must be zero: the kernel adds into them.  lanes: the group width
// G of kernels/ssm_scan.py lanes_for(), as for the forward.
extern "C" int ssm_scan_bwd_launch(const float* dt, const float* Bm,
                                   const float* Cm, const float* x,
                                   const float* A, const float* dy,
                                   const float* dh, float* ckpt, float* ddt,
                                   float* dBm, float* dCm, float* dx,
                                   float* dA, int B, int S, int Dss, int N,
                                   int lanes, void* stream) {
    if (B < 1 || B > 65535 || S < 1 || Dss < 1 || N < 1 || N > 64
            || lanes < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int E = (N + lanes - 1) / lanes;
#define SB_CASE(g, e)                                                        \
    if (lanes == g && E == e)                                                \
        return sb_launch<g, e>(dt, Bm, Cm, x, A, dy, dh, ckpt, ddt, dBm,     \
                               dCm, dx, dA, B, S, Dss, N, s);
    SB_CASE(1, 1) SB_CASE(1, 2) SB_CASE(2, 2) SB_CASE(4, 2) SB_CASE(8, 2)
    SB_CASE(16, 2) SB_CASE(32, 2)
#undef SB_CASE
    return (int)cudaErrorInvalidValue;
}
