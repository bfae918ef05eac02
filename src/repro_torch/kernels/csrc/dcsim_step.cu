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
// Replicas: the call may advance R independent farms at once (a Monte
// Carlo batch, core/montecarlo.py).  Every per-server array is then
// (R, N, ...) and t, t_next and cand are (R,); blockIdx.y is the replica,
// and each replica's minimum is its own.  R = 1 is the single farm, with
// the geometry below unchanged.
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
//   - A replica whose servers fit one block (gridDim.x == 1: N <= 256, or
//     a batch large enough that the wrapper's plan gives each replica one
//     block) writes its candidate straight from the block minimum, with
//     no atomics.  Otherwise each replica has its own ticket and minimum
//     word, and its last block writes its candidate, as above.
//   - The scratch words (R tickets, then R minima) belong to the wrapper,
//     one set per device and batch size, so a call allocates nothing for
//     the reduction.
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
//
// Two instances, one per clock type (template parameter T): float32, and
// float64 for a simulation clock that must not lose precision at large t
// (at t = 86,400 s a float32 ulp is about 8 ms).  In the float64 instance
// the core slots, t, t_next, wake_at, idle_since, tau, the freed slots and
// the candidate are double, and the completion test and the candidate's
// minimum run in double; dt = float(t_next - t) and the power, energy and
// busy seconds stay float32, as the plain version computes them.  Its
// minimum goes through a 64-bit order image, and its scratch is a pair of
// 64-bit words (ticket, minimum).  It reads the core slots as scalars
// (no float4 path).

#include <cuda_runtime.h>
#include <stdint.h>

#define DCSIM_THREADS 256

// The clock type's constants and its float <-> order-image maps: a < b
// exactly when image(a) < image(b) as unsigned integers (sign bit set: all
// bits flipped; clear: the sign bit set), so an integer atomicMin takes
// the minimum.  Img is also the type of the scratch words.
template <typename T> struct Clock;

template <> struct Clock<float> {
    typedef unsigned int Img;
    static constexpr float INF = 1.0e30f;
    static constexpr Img EMPTY = 0xffffffffu;
    __device__ static Img image(float v) {
        const unsigned int u = __float_as_uint(v);
        return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    }
    __device__ static float from_image(Img u) {
        return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
    }
    __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
    __device__ static float lo(float a, float b) { return fminf(a, b); }
    __device__ static float diff_f32(float a, float b) {
        return __fsub_rn(a, b);
    }
};

template <> struct Clock<double> {
    typedef unsigned long long Img;
    static constexpr double INF = 1.0e30;
    static constexpr Img EMPTY = 0xffffffffffffffffull;
    __device__ static Img image(double v) {
        const Img u = (Img)__double_as_longlong(v);
        return (u & 0x8000000000000000ull) ? ~u
                                           : (u | 0x8000000000000000ull);
    }
    __device__ static double from_image(Img u) {
        return __longlong_as_double((long long)(
            (u & 0x8000000000000000ull) ? (u & 0x7fffffffffffffffull) : ~u));
    }
    __device__ static double add(double a, double b) {
        return __dadd_rn(a, b);
    }
    __device__ static double lo(double a, double b) { return fmin(a, b); }
    // dt rounds once, from the exact double difference to float32
    __device__ static float diff_f32(double a, double b) {
        return __double2float_rn(__dsub_rn(a, b));
    }
};

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = Clock<T>::lo(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// Block-wide minimum; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_min(T v) {
    __shared__ T warp_part[DCSIM_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_min(v);
    if (lane == 0) warp_part[warp] = v;
    __syncthreads();
    const int n_warps = (blockDim.x + 31) >> 5;
    v = (threadIdx.x < n_warps) ? warp_part[threadIdx.x] : Clock<T>::INF;
    if (warp == 0) v = warp_min(v);
    return v;
}

// One server's advance; returns its next-event candidate.
template <typename T>
__device__ __forceinline__ T advance_server(
        int i, const T* __restrict__ core_busy,
        const int* __restrict__ srv_state, const float* __restrict__ energy,
        const float* __restrict__ busy_seconds,
        const T* __restrict__ wake_at,
        const T* __restrict__ idle_since, const T* __restrict__ tau,
        const int* __restrict__ throttled, const float* __restrict__ table,
        float dt, T t_next, float p_act, float p_act_thr, float p_idle,
        int c, int vec4, T* __restrict__ new_busy,
        uint8_t* __restrict__ done, float* __restrict__ new_energy,
        float* __restrict__ new_busy_seconds) {
    const T INF = Clock<T>::INF;
    // every load first, so all of them are in flight before any store
    const int st = srv_state[i];
    const bool thr = throttled != nullptr && throttled[i] != 0;
    const float e = energy[i], bsec = busy_seconds[i];
    const T wake = wake_at != nullptr ? wake_at[i] : INF;
    const T since = idle_since != nullptr ? idle_since[i] : T(0);
    const T tv = tau != nullptr ? tau[i] : INF;
    float busy = 0.0f;
    T slot_min = INF;
    if (vec4) {                 // float32 only (the wrapper's plan)
        const float4 v = reinterpret_cast<const float4*>(core_busy)[i];
        float b[4] = {v.x, v.y, v.z, v.w};
        unsigned char dd[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            busy += (b[j] < INF) ? 1.0f : 0.0f;
            dd[j] = (b[j] <= t_next) ? 1 : 0;
            b[j] = dd[j] ? (float)INF : b[j];
            slot_min = Clock<T>::lo(slot_min, (T)b[j]);
        }
        reinterpret_cast<float4*>(new_busy)[i] =
            make_float4(b[0], b[1], b[2], b[3]);
        reinterpret_cast<uchar4*>(done)[i] =
            make_uchar4(dd[0], dd[1], dd[2], dd[3]);
    } else {
        for (int j = 0; j < c; ++j) {
            const long k = (long)i * c + j;
            T b = core_busy[k];
            busy += (b < INF) ? 1.0f : 0.0f;
            const bool fin = b <= t_next;
            b = fin ? INF : b;
            done[k] = fin ? 1 : 0;
            new_busy[k] = b;
            slot_min = Clock<T>::lo(slot_min, b);
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
    const T timer = st == 1 ? Clock<T>::add(since, tv) : INF;
    return Clock<T>::lo(slot_min, Clock<T>::lo(wake, timer));
}

template <typename T>
__global__ void __launch_bounds__(DCSIM_THREADS)
dcsim_advance_kernel(const T* __restrict__ core_busy,
                     const int* __restrict__ srv_state,
                     const float* __restrict__ energy,
                     const float* __restrict__ busy_seconds,
                     const T* __restrict__ wake_at,
                     const T* __restrict__ idle_since,
                     const T* __restrict__ tau,
                     const int* __restrict__ throttled,
                     const float* __restrict__ table,
                     const T* __restrict__ t_ptr,
                     const T* __restrict__ t_next_ptr,
                     float p_act, float p_act_thr, float p_idle,
                     int n, int c, int vec4,
                     T* __restrict__ new_busy,
                     uint8_t* __restrict__ done,
                     float* __restrict__ new_energy,
                     float* __restrict__ new_busy_seconds,
                     typename Clock<T>::Img* ticket,
                     typename Clock<T>::Img* min_image,
                     T* __restrict__ cand) {
    typedef typename Clock<T>::Img Img;
    // this block's replica: its farm's rows and its own scratch words
    const int r = blockIdx.y;
    const long srv0 = (long)r * n, slot0 = srv0 * c;
    core_busy += slot0;
    new_busy += slot0;
    done += slot0;
    srv_state += srv0;
    energy += srv0;
    busy_seconds += srv0;
    new_energy += srv0;
    new_busy_seconds += srv0;
    if (wake_at != nullptr) wake_at += srv0;
    if (idle_since != nullptr) idle_since += srv0;
    if (tau != nullptr) tau += srv0;
    if (throttled != nullptr) throttled += srv0;
    const T t = t_ptr[r], t_next = t_next_ptr[r];
    const float dt = Clock<T>::diff_f32(t_next, t);
    T m = Clock<T>::INF;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        m = Clock<T>::lo(m, advance_server<T>(
            i, core_busy, srv_state, energy, busy_seconds, wake_at,
            idle_since, tau, throttled, table, dt, t_next, p_act, p_act_thr,
            p_idle, c, vec4, new_busy, done, new_energy, new_busy_seconds));
    m = block_min(m);
    if (threadIdx.x == 0) {
        if (gridDim.x == 1) {       // the whole replica in this block
            cand[r] = m;
            return;
        }
        atomicMin(min_image + r, Clock<T>::image(m));
        __threadfence();            // the minimum lands before the ticket
        // the last block reads the farm-wide minimum and resets both words
        // for the next launch
        if (atomicAdd(ticket + r, (Img)1) == (Img)(gridDim.x - 1)) {
            cand[r] = Clock<T>::from_image(atomicExch(min_image + r,
                                                      Clock<T>::EMPTY));
            ticket[r] = (Img)0;
        }
    }
}

template <typename T>
static int launch(const T* core_busy, const int* srv_state,
                  const float* energy, const float* busy_seconds,
                  const T* wake_at, const T* idle_since, const T* tau,
                  const int* throttled, const float* table, const T* t,
                  const T* t_next, float p_act, float p_act_thr,
                  float p_idle, int n, int c, int grid, int reps, int vec4,
                  T* new_busy, uint8_t* done, float* new_energy,
                  float* new_busy_seconds, typename Clock<T>::Img* ticket,
                  typename Clock<T>::Img* min_image, T* cand,
                  void* stream) {
    if (n <= 0 || c <= 0 || grid <= 0 || reps <= 0 || reps > 65535)
        return (int)cudaErrorInvalidValue;
    if (vec4 && (sizeof(T) != 4 || c != 4
                 || ((uintptr_t)core_busy % 16) != 0
                 || ((uintptr_t)new_busy % 16) != 0
                 || ((uintptr_t)done % 4) != 0))
        return (int)cudaErrorMisalignedAddress;
    dcsim_advance_kernel<T><<<dim3(grid, reps), DCSIM_THREADS, 0,
                              (cudaStream_t)stream>>>(
        core_busy, srv_state, energy, busy_seconds, wake_at, idle_since, tau,
        throttled, table, t, t_next, p_act, p_act_thr, p_idle, n, c, vec4,
        new_busy, done, new_energy, new_busy_seconds, ticket, min_image,
        cand);
    return (int)cudaGetLastError();
}

extern "C" int dcsim_advance_launch(
        const float* core_busy, const int* srv_state, const float* energy,
        const float* busy_seconds, const float* wake_at,
        const float* idle_since, const float* tau, const int* throttled,
        const float* table, const float* t, const float* t_next,
        float p_act, float p_act_thr, float p_idle, int n, int c, int grid,
        int reps, int vec4, float* new_busy, uint8_t* done,
        float* new_energy, float* new_busy_seconds, unsigned int* ticket,
        unsigned int* min_image, float* cand, void* stream) {
    return launch<float>(core_busy, srv_state, energy, busy_seconds,
                         wake_at, idle_since, tau, throttled, table, t,
                         t_next, p_act, p_act_thr, p_idle, n, c, grid, reps,
                         vec4,
                         new_busy, done, new_energy, new_busy_seconds,
                         ticket, min_image, cand, stream);
}

extern "C" int dcsim_advance_launch_f64(
        const double* core_busy, const int* srv_state, const float* energy,
        const float* busy_seconds, const double* wake_at,
        const double* idle_since, const double* tau, const int* throttled,
        const float* table, const double* t, const double* t_next,
        float p_act, float p_act_thr, float p_idle, int n, int c, int grid,
        int reps, double* new_busy, uint8_t* done, float* new_energy,
        float* new_busy_seconds, unsigned long long* ticket,
        unsigned long long* min_image, double* cand, void* stream) {
    return launch<double>(core_busy, srv_state, energy, busy_seconds,
                          wake_at, idle_since, tau, throttled, table, t,
                          t_next, p_act, p_act_thr, p_idle, n, c, grid, reps,
                          0,
                          new_busy, done, new_energy, new_busy_seconds,
                          ticket, min_image, cand, stream);
}
