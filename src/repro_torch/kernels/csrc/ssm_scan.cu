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
// Design: one thread per (batch, channel) keeps the N-value state in
// registers and loops over time inside the block; that loop takes the
// place of the TPU's sequential grid axis.  A chunk of SS_CHUNK steps of
// dt and x (one value per thread and step, read coalesced along the
// channel dimension) is loaded into registers at once, and the chunk's
// B and C rows, which every channel shares, are staged in shared memory.
// Any Dss and S are taken: channels past Dss and steps past S are masked,
// where the TPU kernel asserts Dss % block_d == 0 and S % chunk_t == 0.
// The update repeats the plain version's roundings (__fmul_rn/__fadd_rn,
// never contracted into an FMA; expf, no fast math), so h matches it; y
// sums over n in order 0..N-1, the plain version in its own order.
//
// What bounds it on the card: at hymba-1.5b's prefill (B=4, S=1,536,
// Dss=3,200, N=16) it must move about 237 MB (dt, x and y dominate:
// about 71 us at 3.35 TB/s) and take 314.6 M exponentials, one per
// state element and step.  The recurrence leaves only B*Dss = 12,800
// threads, about a hundred per SM, each with a serial chain of S steps,
// so this first version is bound by that chain's latency, not by either
// peak; splitting N across threads or a chunked parallel scan over time
// is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#define SS_THREADS 64
#define SS_CHUNK 32

template <int MAXN>
__global__ void __launch_bounds__(SS_THREADS)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ x,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ h_out, int S, int Dss, int N) {
    __shared__ float sB[SS_CHUNK * MAXN];
    __shared__ float sC[SS_CHUNK * MAXN];
    const int b = blockIdx.y;
    const int d = blockIdx.x * SS_THREADS + threadIdx.x;
    const bool live = d < Dss;

    float a[MAXN], h[MAXN];
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
        a[n] = (live && n < N) ? A[(long long)d * N + n] : 0.0f;
        h[n] = 0.0f;
    }
    const long long row = (long long)b * S;          // (b, t) row base

    for (int t0 = 0; t0 < S; t0 += SS_CHUNK) {
        const int T = min(SS_CHUNK, S - t0);
        __syncthreads();                 // the last chunk's B/C reads done
        for (int e = threadIdx.x; e < T * N; e += SS_THREADS) {
            const int t = e / N, n = e % N;
            sB[t * MAXN + n] = Bm[(row + t0 + t) * N + n];
            sC[t * MAXN + n] = Cm[(row + t0 + t) * N + n];
        }
        float dtv[SS_CHUNK], xv[SS_CHUNK];
#pragma unroll
        for (int t = 0; t < SS_CHUNK; ++t) {
            const bool ok = live && t < T;
            const long long idx = (row + t0 + t) * Dss + d;
            dtv[t] = ok ? dt[idx] : 0.0f;
            xv[t] = ok ? x[idx] : 0.0f;
        }
        __syncthreads();

#pragma unroll
        for (int t = 0; t < SS_CHUNK; ++t) {
            if (t < T) {
                const float u = __fmul_rn(dtv[t], xv[t]);
                float acc = 0.0f;
#pragma unroll
                for (int n = 0; n < MAXN; ++n) {
                    if (n < N) {
                        const float da = expf(__fmul_rn(dtv[t], a[n]));
                        h[n] = __fadd_rn(__fmul_rn(da, h[n]),
                                         __fmul_rn(u, sB[t * MAXN + n]));
                        acc = __fadd_rn(acc,
                                        __fmul_rn(h[n], sC[t * MAXN + n]));
                    }
                }
                if (live) y[(row + t0 + t) * Dss + d] = acc;
            }
        }
    }
    if (live) {
#pragma unroll
        for (int n = 0; n < MAXN; ++n)
            if (n < N) h_out[((long long)b * Dss + d) * N + n] = h[n];
    }
}

// All arrays float32 and contiguous: dt/x/y (B, S, Dss), Bm/Cm (B, S, N),
// A (Dss, N), h (B, Dss, N).
extern "C" int ssm_scan_launch(const float* dt, const float* Bm,
                               const float* Cm, const float* x,
                               const float* A, float* y, float* h,
                               int B, int S, int Dss, int N, void* stream) {
    if (B < 1 || B > 65535 || S < 1 || Dss < 1 || N < 1 || N > 64)
        return (int)cudaErrorInvalidValue;
    dim3 grid((Dss + SS_THREADS - 1) / SS_THREADS, B);
    cudaStream_t s = (cudaStream_t)stream;
    if (N <= 16)
        ssm_scan_kernel<16><<<grid, SS_THREADS, 0, s>>>(dt, Bm, Cm, x, A, y,
                                                        h, S, Dss, N);
    else
        ssm_scan_kernel<64><<<grid, SS_THREADS, 0, s>>>(dt, Bm, Cm, x, A, y,
                                                        h, S, Dss, N);
    return (int)cudaGetLastError();
}
