// Selective-SSM scan (the Mamba mixer of hymba) for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan,
// body _kernel), which keeps a (block_d, N) state in VMEM scratch across a
// sequential grid axis of time chunks.  Computes what the plain version
// (kernels/ref.py ssm_scan_reference) computes, in float32:
//   h[b, d, :] = 0
//   for t < S:  da = exp(dt[b,t,d] * A[d,:])
//               h[b,d,:] = da * h[b,d,:] + (dt[b,t,d] * x[b,t,d]) * B[b,t,:]
//               y[b,t,d] = sum_n h[b,d,n] * C[b,t,n]
// and returns the final state h as well as y (prefill stores it in the
// decode cache; the TPU kernel writes y only).
//
// What bounds it on the card: at hymba-1.5b's prefill (B=4, S=1,536,
// Dss=3,200, N=16) it must move about 237 MB (dt, x and y dominate: about
// 71 us at 3.35 TB/s) and take 314.6 M exponentials, one per state
// element and step: about 75 us on the special-function units (16 per SM
// per clock at 1,980 MHz), the larger of the two.  Neither is what holds
// it: the accurate expf that the plain version's roundings need is eight
// instructions, and with the update, its part of y and the loads a state
// element takes an estimated 16 instructions a step, about 150 us at the
// SMs' full issue rate; this kernel reaches about half of that rate.
//
// Design: a group of G lanes owns one (batch, channel), each lane two
// state elements n and n + G (one at N = 1), G = N / 2 rounded up to a
// power of two: 8 lanes at N = 16, 102,400 threads at hymba's shape, 8
// times one thread per channel.  Each lane keeps its a[n] and h[n] in
// registers and loops over time; the loop takes the place of the TPU's
// sequential grid axis.  A block of 128 threads owns 128 / G channels of
// one batch row: 800 blocks at hymba's shape.  Builds of the alternatives,
// timed on the card while this design was chosen and not kept in the
// source, were slower: one lane per state element (16 lanes, 204,800
// threads), four or eight elements a lane, and y by a shuffle tree
// (below).  Two independent exponentials a lane-step in an unrolled chunk
// are worth more here than more warps.
//
// Inputs stream through shared memory in chunks of SS_T steps, double
// buffered: the chunk's dt/x (coalesced along the channel dimension) and
// B/C rows (shared by every channel of the block) arrive by 4-byte
// cp.async, transposed so that a lane reads four steps of each as one
// float4.  Each thread's copy offsets are worked out once, before the
// loop.  The next chunk's copies are issued right after the chunk
// barrier and land while this chunk computes; one __syncthreads per chunk.
// A full chunk runs its 16 steps unrolled with no check against S; the
// last, partial chunk runs as a plain loop.
//
// y without a shuffle per step: each lane writes its part of
// sum_n h[n]*C[n] (its two elements added) for every step of the chunk
// into shared memory, and after the chunk lane j of the group sums step
// j's G parts in order (a warp-local __syncwarp, no block barrier).  The
// alternative, a shuffle tree per step (log2(G) shuffles a lane-step),
// measured slower.  The plain version sums over n in its own order (y
// within 1e-5).
//
// The update repeats the plain version's roundings (__fmul_rn/__fadd_rn,
// never contracted into an FMA; expf, no fast math), so h is the plain
// version's recurrence element for element.  Any Dss and S are taken:
// channels past Dss and steps past S are masked.  The serial chain over
// time (two dependent roundings a step, 1,536 steps) takes a few
// microseconds, so it is not what holds the kernel: a chunked parallel
// scan over time, which would also change h's rounding, is not the next
// step; fewer instructions per element and step are.

#include <cuda_runtime.h>
#include <stdint.h>

#define SS_T 16                 // steps per chunk
#define SS_TP (SS_T + 4)        // padded smem row of one channel / state
#define SS_THREADS 128

// shared floats of one block: dt and x (2 x CPB rows each), B and C
// (2 x NP rows each), the partials of y (CPB x SS_T x (G + 1), G > 1)
template <int G, int E>
constexpr size_t ss_smem_floats() {
    return (size_t)4 * (SS_THREADS / G) * SS_TP + (size_t)4 * G * E * SS_TP
           + (G > 1 ? (size_t)(SS_THREADS / G) * SS_T * (G + 1) : 0);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ float f4_at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int G, int E>
__global__ void __launch_bounds__(SS_THREADS)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ x,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ h_out, int S, int Dss, int N) {
    constexpr int CPB = SS_THREADS / G;         // channels per block
    constexpr int NP = G * E;                   // state rows held
    constexpr int CBS = G + 1;                  // partials row stride
    extern __shared__ float4 ss_smem4[];
    float* sDt = reinterpret_cast<float*>(ss_smem4);  // [2][CPB][SS_TP]
    float* sX = sDt + 2 * CPB * SS_TP;                // [2][CPB][SS_TP]
    float* sB = sX + 2 * CPB * SS_TP;                 // [2][NP][SS_TP]
    float* sC = sB + 2 * NP * SS_TP;                  // [2][NP][SS_TP]
    float* sCb = sC + 2 * NP * SS_TP;                 // [CPB][SS_T][CBS]

    const int tid = threadIdx.x, c = tid / G, n = tid % G;
    const int b = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + c;
    const bool live = d < Dss;
    const long long row0 = (long long)b * S;           // (b, t) row base

    // rows that no copy fills (states n >= N, channels past Dss) stay 0
    for (int e = tid; e < 4 * CPB * SS_TP + 4 * NP * SS_TP; e += SS_THREADS)
        sDt[e] = 0.0f;

    float a[E], hs[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int nn = n + j * G;
        a[j] = (live && nn < N) ? A[(long long)d * N + nn] : 0.0f;
        hs[j] = 0.0f;
    }

    // This thread's copies of every chunk, worked out once: dt/x element
    // e = (step t, channel cc) and B/C element e = (t, state nn) of the
    // chunk, their offsets from the chunk's first global row and in the
    // (transposed) shared buffer.  A slot with no copy has step SS_T.
    constexpr int DXS = (SS_T * CPB + SS_THREADS - 1) / SS_THREADS;
    constexpr int BCS = (SS_T * NP + SS_THREADS - 1) / SS_THREADS;
    int dx_t[DXS], dx_g[DXS], dx_s[DXS], bc_t[BCS], bc_s[BCS];
#pragma unroll
    for (int k = 0; k < DXS; ++k) {
        const int e = tid + k * SS_THREADS, t = e / CPB, cc = e % CPB;
        dx_t[k] = (t < SS_T && d0 + cc < Dss) ? t : SS_T;
        dx_g[k] = dx_t[k] < SS_T ? t * Dss + cc : 0;
        dx_s[k] = cc * SS_TP + t;
    }
#pragma unroll
    for (int k = 0; k < BCS; ++k) {
        const int e = tid + k * SS_THREADS, t = e / N, nn = e % N;
        bc_t[k] = t < SS_T ? t : SS_T;
        bc_s[k] = nn * SS_TP + t;
    }
    __syncthreads();                    // zeros stored before any copy

    auto load = [&](int t0, int buf) {
        const int T = min(SS_T, S - t0);
        const float* gdt = dt + (row0 + t0) * Dss + d0;
        const float* gx = x + (row0 + t0) * Dss + d0;
        const float* gB = Bm + (row0 + t0) * N + tid;
        const float* gC = Cm + (row0 + t0) * N + tid;
        float* bdx = sDt + buf * CPB * SS_TP;
        float* bbc = sB + buf * NP * SS_TP;
        const int dx_x = 2 * CPB * SS_TP;      // sX - sDt
        const int bc_c = 2 * NP * SS_TP;       // sC - sB
#pragma unroll
        for (int k = 0; k < DXS; ++k)
            if (dx_t[k] < T) {
                cp_async4(bdx + dx_s[k], gdt + dx_g[k]);
                cp_async4(bdx + dx_x + dx_s[k], gx + dx_g[k]);
            }
#pragma unroll
        for (int k = 0; k < BCS; ++k)
            if (bc_t[k] < T) {
                cp_async4(bbc + bc_s[k], gB + k * SS_THREADS);
                cp_async4(bbc + bc_c + bc_s[k], gC + k * SS_THREADS);
            }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    float* cb = sCb + c * SS_T * CBS;
    load(0, 0);
    for (int t0 = 0, buf = 0; t0 < S; t0 += SS_T, buf ^= 1) {
        const int T = min(SS_T, S - t0);
        // this chunk has landed (every thread's copies) and every thread
        // is done with the last chunk, whose buffer the next copies fill
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        if (t0 + SS_T < S) load(t0 + SS_T, buf ^ 1);

        const float* pdt = sDt + (buf * CPB + c) * SS_TP;
        const float* px = sX + (buf * CPB + c) * SS_TP;
        const float* pB = sB + (buf * NP + n) * SS_TP;
        const float* pC = sC + (buf * NP + n) * SS_TP;
        float* yc = y + (row0 + t0) * Dss + d;
        // one step t of the chunk: the update of this lane's elements and
        // its part of y
        auto step = [&](int t, float dtv, float xv, const float (&bv)[E],
                        const float (&cv)[E]) {
            const float u = __fmul_rn(dtv, xv);
            float part = 0.0f;
#pragma unroll
            for (int j = 0; j < E; ++j) {
                const float da = expf(__fmul_rn(dtv, a[j]));
                hs[j] = __fadd_rn(__fmul_rn(da, hs[j]), __fmul_rn(u, bv[j]));
                const float hc = __fmul_rn(hs[j], cv[j]);
                part = j == 0 ? hc : __fadd_rn(part, hc);
            }
            if (G == 1) {
                if (live) yc[(long long)t * Dss] = part;
            } else {
                cb[t * CBS + n] = part;
            }
        };
        if (T == SS_T) {
            // a full chunk: 16 steps unrolled, four steps of every input
            // read as one float4
#pragma unroll
            for (int t4 = 0; t4 < SS_T; t4 += 4) {
                const float4 dt4 = *reinterpret_cast<const float4*>(pdt + t4);
                const float4 x4 = *reinterpret_cast<const float4*>(px + t4);
                float4 B4[E], C4[E];
#pragma unroll
                for (int j = 0; j < E; ++j) {
                    B4[j] = *reinterpret_cast<const float4*>(
                        pB + j * G * SS_TP + t4);
                    C4[j] = *reinterpret_cast<const float4*>(
                        pC + j * G * SS_TP + t4);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    float bv[E], cv[E];
#pragma unroll
                    for (int j = 0; j < E; ++j) {
                        bv[j] = f4_at(B4[j], i);
                        cv[j] = f4_at(C4[j], i);
                    }
                    step(t4 + i, f4_at(dt4, i), f4_at(x4, i), bv, cv);
                }
            }
        } else {
            // the last chunk, T < SS_T steps
#pragma unroll 1
            for (int t = 0; t < T; ++t) {
                float bv[E], cv[E];
#pragma unroll
                for (int j = 0; j < E; ++j) {
                    bv[j] = pB[j * G * SS_TP + t];
                    cv[j] = pC[j * G * SS_TP + t];
                }
                step(t, pdt[t], px[t], bv, cv);
            }
        }
        if (G > 1) {
            __syncwarp();               // the group (inside one warp) wrote
            for (int t = n; t < T; t += G) {
                const float* row = cb + t * CBS;
                float acc = row[0];
#pragma unroll
                for (int l = 1; l < G; ++l) acc = __fadd_rn(acc, row[l]);
                if (live) yc[(long long)t * Dss] = acc;
            }
            __syncwarp();               // read before the next chunk writes
        }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int nn = n + j * G;
        if (live && nn < N) h_out[((long long)b * Dss + d) * N + nn] = hs[j];
    }
}

template <int G, int E>
static int ss_launch(const float* dt, const float* Bm, const float* Cm,
                     const float* x, const float* A, float* y, float* h,
                     int B, int S, int Dss, int N, cudaStream_t s) {
    constexpr int CPB = SS_THREADS / G;
    const size_t smem = sizeof(float) * ss_smem_floats<G, E>();
    dim3 grid((Dss + CPB - 1) / CPB, B);
    ssm_scan_kernel<G, E><<<grid, SS_THREADS, smem, s>>>(
        dt, Bm, Cm, x, A, y, h, S, Dss, N);
    return (int)cudaGetLastError();
}

// All arrays float32 and contiguous: dt/x/y (B, S, Dss), Bm/Cm (B, S, N),
// A (Dss, N), h (B, Dss, N).  lanes: the group width G the wrapper chose
// (kernels/ssm_scan.py lanes_for()); each lane holds E = ceil(N / G) state
// elements, one at N = 1 and two otherwise.
extern "C" int ssm_scan_launch(const float* dt, const float* Bm,
                               const float* Cm, const float* x,
                               const float* A, float* y, float* h,
                               int B, int S, int Dss, int N, int lanes,
                               void* stream) {
    if (B < 1 || B > 65535 || S < 1 || Dss < 1 || N < 1 || N > 64
            || lanes < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int E = (N + lanes - 1) / lanes;
#define SS_CASE(g, e)                                                        \
    if (lanes == g && E == e)                                                \
        return ss_launch<g, e>(dt, Bm, Cm, x, A, y, h, B, S, Dss, N, s);
    SS_CASE(1, 1) SS_CASE(1, 2) SS_CASE(2, 2) SS_CASE(4, 2) SS_CASE(8, 2)
    SS_CASE(16, 2) SS_CASE(32, 2)
#undef SS_CASE
    return (int)cudaErrorInvalidValue;
}
