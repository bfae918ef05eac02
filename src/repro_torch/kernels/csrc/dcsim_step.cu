// Fused farm advance for Hopper (sm_90a): the interval advance of the
// discrete-event engine, one launch per call.
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
// What bounds it: at N = 65,536 servers x C = 4 the call reads about
// 2.9 MB and writes about 1.8 MB, 4.7 MB in all, 1.41 us at 3.35 TB/s,
// and does a few dozen flops per server.  A kernel launch's ramp (blocks
// handed to the SMs, the first loads' latency, the last stores draining)
// is of the same size, so the design spends as few ramps as it can and
// keeps every byte in flight at once:
//   - One launch.  Each block takes its minimum to one word of the
//     wrapper's scratch with an integer atomicMin on the float's
//     order-preserving image, then takes a ticket (atomicAdd after
//     __threadfence).  The block that draws the last ticket swaps the
//     word back to its empty value, writes cand from it and sets the
//     ticket back to 0, so no second launch and no host write resets
//     either.  An integer minimum is exact and order-free, so cand does
//     not depend on the order of the blocks.  The cross-block step costs
//     three round trips to L2 in the last block (the fence, the ticket,
//     the swap); a second launch cost more.
//   - Geometry (dcsim_step.py plan): 256 threads a block, one server a
//     thread, at most BLOCKS_PER_SM blocks an SM and a grid-stride loop
//     past that.  At N = 65,536 that is 256 blocks, all resident at
//     once on 132 SMs, each thread with its ~9 loads (one float4 of core
//     slots when C == 4, the rest scalars) issued before its first
//     store: the whole 4.7 MB is in flight in one round trip.  The ragged
//     tail is masked.
//   - The two scratch words (ticket, minimum) belong to the wrapper, one
//     pair per device, so a call allocates nothing for the reduction.
//     Two launches that overlap on two streams of one device would share
//     them and mix their minima: the port issues every call on the
//     current stream, in order, and the wrapper documents the rule.  A
//     CUDA graph replays the launch as it is, resets included.
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

// The float's order-preserving image: a < b exactly when image(a) <
// image(b) as unsigned integers (sign bit set: all bits flipped; clear:
// the sign bit set), so an integer atomicMin takes the float minimum.
__device__ __forceinline__ unsigned int order_image(float v) {
    const unsigned int u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_image(unsigned int u) {
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// One server's advance; returns its next-event candidate.
__device__ __forceinline__ float advance_server(
        int i, const float* __restrict__ core_busy,
        const int* __restrict__ srv_state, const float* __restrict__ energy,
        const float* __restrict__ busy_seconds,
        const float* __restrict__ wake_at,
        const float* __restrict__ idle_since, const float* __restrict__ tau,
        const int* __restrict__ throttled, const float* __restrict__ table,
        float dt, float t_next, float p_act, float p_act_thr, float p_idle,
        int c, int vec4, float* __restrict__ new_busy,
        uint8_t* __restrict__ done, float* __restrict__ new_energy,
        float* __restrict__ new_busy_seconds) {
    // every load first, so all of them are in flight before any store
    const int st = srv_state[i];
    const bool thr = throttled != nullptr && throttled[i] != 0;
    const float e = energy[i], bsec = busy_seconds[i];
    const float wake = wake_at != nullptr ? wake_at[i] : DCSIM_INF;
    const float since = idle_since != nullptr ? idle_since[i] : 0.0f;
    const float tv = tau != nullptr ? tau[i] : DCSIM_INF;
    float busy = 0.0f, slot_min = DCSIM_INF;
    if (vec4) {
        const float4 v = reinterpret_cast<const float4*>(core_busy)[i];
        float b[4] = {v.x, v.y, v.z, v.w};
        unsigned char dd[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            busy += (b[j] < DCSIM_INF) ? 1.0f : 0.0f;
            dd[j] = (b[j] <= t_next) ? 1 : 0;
            b[j] = dd[j] ? DCSIM_INF : b[j];
            slot_min = fminf(slot_min, b[j]);
        }
        reinterpret_cast<float4*>(new_busy)[i] =
            make_float4(b[0], b[1], b[2], b[3]);
        reinterpret_cast<uchar4*>(done)[i] =
            make_uchar4(dd[0], dd[1], dd[2], dd[3]);
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
    float p;
    if (st <= 1) {
        const float pa = thr ? p_act_thr : p_act;
        p = __fadd_rn(__fadd_rn(table[0], __fmul_rn(busy, pa)),
                      __fmul_rn(__fsub_rn((float)c, busy), p_idle));
    } else {
        p = table[st < 0 ? 0 : (st > 5 ? 5 : st)];
    }
    new_energy[i] = __fadd_rn(e, __fmul_rn(p, dt));
    new_busy_seconds[i] = __fadd_rn(bsec, __fmul_rn(busy, dt));
    const float timer = st == 1 ? __fadd_rn(since, tv) : DCSIM_INF;
    return fminf(slot_min, fminf(wake, timer));
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
                     unsigned int* ticket, unsigned int* min_image,
                     float* __restrict__ cand) {
    const float t = *t_ptr, t_next = *t_next_ptr;
    const float dt = __fsub_rn(t_next, t);
    float m = DCSIM_INF;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        m = fminf(m, advance_server(
            i, core_busy, srv_state, energy, busy_seconds, wake_at,
            idle_since, tau, throttled, table, dt, t_next, p_act, p_act_thr,
            p_idle, c, vec4, new_busy, done, new_energy, new_busy_seconds));
    m = block_min(m);
    if (threadIdx.x == 0) {
        atomicMin(min_image, order_image(m));
        __threadfence();            // the minimum lands before the ticket
        // the last block reads the farm-wide minimum and resets both words
        // for the next launch
        if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
            *cand = from_order_image(atomicExch(min_image, 0xffffffffu));
            *ticket = 0u;
        }
    }
}

extern "C" int dcsim_advance_launch(
        const float* core_busy, const int* srv_state, const float* energy,
        const float* busy_seconds, const float* wake_at,
        const float* idle_since, const float* tau, const int* throttled,
        const float* table, const float* t, const float* t_next,
        float p_act, float p_act_thr, float p_idle, int n, int c, int grid,
        int vec4, float* new_busy, uint8_t* done, float* new_energy,
        float* new_busy_seconds, unsigned int* ticket,
        unsigned int* min_image, float* cand, void* stream) {
    if (n <= 0 || c <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
    if (vec4 && (c != 4 || ((uintptr_t)core_busy % 16) != 0
                 || ((uintptr_t)new_busy % 16) != 0
                 || ((uintptr_t)done % 4) != 0))
        return (int)cudaErrorMisalignedAddress;
    dcsim_advance_kernel<<<grid, DCSIM_THREADS, 0, (cudaStream_t)stream>>>(
        core_busy, srv_state, energy, busy_seconds, wake_at, idle_since, tau,
        throttled, table, t, t_next, p_act, p_act_thr, p_idle, n, c, vec4,
        new_busy, done, new_energy, new_busy_seconds, ticket, min_image,
        cand);
    return (int)cudaGetLastError();
}
