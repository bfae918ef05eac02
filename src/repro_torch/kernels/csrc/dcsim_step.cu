// Fused farm advance for Hopper (sm_90a): the interval advance of the
// discrete-event engine, one thread per server.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/dcsim_step.py
// (dcsim_advance, body _kernel), which streams (block_n, C) slabs of the
// farm through VMEM on a sequential-per-core grid.
//
// Per server i (state st, C core slots busy_until[i, :]):
//   busy      = #slots with busy_until < INF
//   p         = table[0] + busy*p_act + (C - busy)*p_idle   if st <= 1
//             = table[clip(st, 0, 5)]                      otherwise
//               (p_act = p_act_thr where throttled[i] != 0)
//   energy   += p*dt ; busy_seconds += busy*dt
//   slots with busy_until <= t_next -> INF, done mask 1
//   candidate = min(surviving busy_until, wake_at, idle_since + tau if IDLE)
// and the farm-wide minimum of the candidates.
//
// What bounds it: memory.  At N = 65,536 servers x C = 4 it reads about
// 2.9 MB and writes about 1.8 MB, about 1.4 us at 3.35 TB/s, and does a
// few dozen flops per server, so in the engine's event loop the launch
// latency (a few us) dominates.  The design therefore fuses the ~15
// elementwise and reduction ops of the plain version into two launches:
// a one-pass kernel whose loads are coalesced (one float4 per server when
// C == 4 and the rows are 16-byte aligned), and a one-block pass that
// reduces the per-block minima.  The ragged tail is masked, not padded.
// The minimum uses warp shuffles and shared memory, never float atomics,
// so the candidate is deterministic.
//
// Roundings match the plain version (kernels/ref.py) operation by
// operation: __fmul_rn/__fadd_rn/__fsub_rn are never contracted into FMAs,
// so energy and busy_seconds are bitwise equal to PyTorch's eager result.
//
// t and t_next are read from device memory so the host never waits for
// the clock.  A null wake_at / idle_since / tau / throttled pointer means
// INF / 0 / INF / not throttled for every server.

#include <cuda_runtime.h>
#include <stdint.h>

#define DCSIM_INF 1.0e30f
#define DCSIM_THREADS 256

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// Block-wide minimum; the result is valid in thread 0.
__device__ __forceinline__ float block_min(float v) {
    __shared__ float warp_part[DCSIM_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_min(v);
    if (lane == 0) warp_part[warp] = v;
    __syncthreads();
    const int n_warps = (blockDim.x + 31) >> 5;
    v = (threadIdx.x < n_warps) ? warp_part[threadIdx.x] : DCSIM_INF;
    if (warp == 0) v = warp_min(v);
    return v;
}

__global__ void __launch_bounds__(DCSIM_THREADS)
dcsim_advance_kernel(const float* __restrict__ core_busy,
                     const int* __restrict__ srv_state,
                     const float* __restrict__ energy,
                     const float* __restrict__ busy_seconds,
                     const float* __restrict__ wake_at,
                     const float* __restrict__ idle_since,
                     const float* __restrict__ tau,
                     const int* __restrict__ throttled,
                     const float* __restrict__ table,
                     const float* __restrict__ t_ptr,
                     const float* __restrict__ t_next_ptr,
                     float p_act, float p_act_thr, float p_idle,
                     int n, int c, int vec4,
                     float* __restrict__ new_busy,
                     uint8_t* __restrict__ done,
                     float* __restrict__ new_energy,
                     float* __restrict__ new_busy_seconds,
                     float* __restrict__ block_cand) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    float cand = DCSIM_INF;
    if (i < n) {
        const float t = *t_ptr, t_next = *t_next_ptr;
        const float dt = __fsub_rn(t_next, t);
        float busy = 0.0f, slot_min = DCSIM_INF;
        if (vec4) {
            const float4 v = reinterpret_cast<const float4*>(core_busy)[i];
            float b[4] = {v.x, v.y, v.z, v.w};
            uchar4 d;
            unsigned char dd[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                busy += (b[j] < DCSIM_INF) ? 1.0f : 0.0f;
                dd[j] = (b[j] <= t_next) ? 1 : 0;
                b[j] = dd[j] ? DCSIM_INF : b[j];
                slot_min = fminf(slot_min, b[j]);
            }
            d.x = dd[0]; d.y = dd[1]; d.z = dd[2]; d.w = dd[3];
            reinterpret_cast<float4*>(new_busy)[i] =
                make_float4(b[0], b[1], b[2], b[3]);
            reinterpret_cast<uchar4*>(done)[i] = d;
        } else {
            for (int j = 0; j < c; ++j) {
                const long k = (long)i * c + j;
                float b = core_busy[k];
                busy += (b < DCSIM_INF) ? 1.0f : 0.0f;
                const bool fin = b <= t_next;
                b = fin ? DCSIM_INF : b;
                done[k] = fin ? 1 : 0;
                new_busy[k] = b;
                slot_min = fminf(slot_min, b);
            }
        }
        const int st = srv_state[i];
        const bool thr = throttled != nullptr && throttled[i] != 0;
        float p;
        if (st <= 1) {
            const float pa = thr ? p_act_thr : p_act;
            p = __fadd_rn(__fadd_rn(table[0], __fmul_rn(busy, pa)),
                          __fmul_rn(__fsub_rn((float)c, busy), p_idle));
        } else {
            p = table[st < 0 ? 0 : (st > 5 ? 5 : st)];
        }
        new_energy[i] = __fadd_rn(energy[i], __fmul_rn(p, dt));
        new_busy_seconds[i] = __fadd_rn(busy_seconds[i], __fmul_rn(busy, dt));
        const float wake = wake_at != nullptr ? wake_at[i] : DCSIM_INF;
        float timer = DCSIM_INF;
        if (st == 1) {
            const float since = idle_since != nullptr ? idle_since[i] : 0.0f;
            const float tv = tau != nullptr ? tau[i] : DCSIM_INF;
            timer = __fadd_rn(since, tv);
        }
        cand = fminf(slot_min, fminf(wake, timer));
    }
    cand = block_min(cand);
    if (threadIdx.x == 0) block_cand[blockIdx.x] = cand;
}

__global__ void __launch_bounds__(DCSIM_THREADS)
dcsim_cand_reduce_kernel(const float* __restrict__ block_cand, int n_blocks,
                         float* __restrict__ cand) {
    float v = DCSIM_INF;
    for (int b = threadIdx.x; b < n_blocks; b += blockDim.x)
        v = fminf(v, block_cand[b]);
    v = block_min(v);
    if (threadIdx.x == 0) *cand = v;
}

extern "C" int dcsim_advance_launch(
        const float* core_busy, const int* srv_state, const float* energy,
        const float* busy_seconds, const float* wake_at,
        const float* idle_since, const float* tau, const int* throttled,
        const float* table, const float* t, const float* t_next,
        float p_act, float p_act_thr, float p_idle, int n, int c,
        float* new_busy, uint8_t* done, float* new_energy,
        float* new_busy_seconds, float* block_cand, float* cand,
        void* stream) {
    if (n <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int n_blocks = (n + DCSIM_THREADS - 1) / DCSIM_THREADS;
    const int vec4 = c == 4
        && ((uintptr_t)core_busy % 16) == 0 && ((uintptr_t)new_busy % 16) == 0
        && ((uintptr_t)done % 4) == 0;
    dcsim_advance_kernel<<<n_blocks, DCSIM_THREADS, 0, s>>>(
        core_busy, srv_state, energy, busy_seconds, wake_at, idle_since, tau,
        throttled, table, t, t_next, p_act, p_act_thr, p_idle, n, c, vec4,
        new_busy, done, new_energy, new_busy_seconds, block_cand);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dcsim_cand_reduce_kernel<<<1, DCSIM_THREADS, 0, s>>>(block_cand,
                                                         n_blocks, cand);
    return (int)cudaGetLastError();
}
