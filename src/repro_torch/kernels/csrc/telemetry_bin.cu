// Fused latency-histogram binning for Hopper (sm_90a), one launch per call.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/telemetry_bin.py
// (telemetry_accum, body _kernel), which bins blocks of latencies by a
// one-hot compare against the bin iota and keeps both histograms and the
// window matrix resident in VMEM across a sequential grid.
//
// Computes, into fresh outputs (the wrapper allocates them and fills
// nothing):
//   job_out  = job_hist  + sum of job_wts[i]  into bin(job_vals[i])
//   task_out = task_hist + sum of task_wts[i] into bin(task_vals[i])
//   win_out  = win, with row widx += wvals     (no row added if widx is
//                                               out of range)
// with bin(v) = clip(int(logf(max(v, lo) * inv_lo) * scale), 0, n_bins - 1)
// and inv_lo the float32 reciprocal of lo, made on the host: the same
// three roundings, in the same order, as the plain version (kernels/ref.py
// log_bin) and as the reference's compiled step, which turns its division
// by the constant lo into that multiplication: a rounded multiply, logf
// (not __logf; the build uses no --use_fast_math), a rounded multiply.
//
// What bounds it: latency.  The engine calls it once per macro-step with
// the full job stream (J,) and task stream (J*T,) and 0/1 weights:
// (J + J*T) * 8 bytes, about 10 KB at J = 600, next to nothing for the
// card.  So the call is one launch with no device copy or fill around it,
// and the kernel's own chain of dependent steps is kept short:
//   - The kernel reads the input histograms and window and writes the
//     outputs itself.  Each thread's first value and weight of each
//     stream, its input bin and its share of the window are loaded
//     together, in one round trip (a value is loaded whatever its weight:
//     with a weight every few values every 32-byte sector is fetched
//     anyway, and the load then waits on nothing).
//   - Values whose weight is 0 are skipped before the log.  A weight of
//     exactly 1 (every weight the engine passes) is counted in an integer
//     histogram, whose shared-memory atomicAdd is one instruction that
//     combines the lanes of a warp (ATOMS.POPC.INC); any other weight goes
//     to a float histogram, whose atomicAdd is a compare-and-swap loop
//     (ATOMS.CAST.SPIN) that retries on every collision.  A bin's total is
//     its float part plus its count.
//   - Two paths, chosen in telemetry_bin.py plan.  Small streams
//     (max(J, M) <= TB_THREADS, the engine's shape): one block bins both
//     streams, copies the window and writes the histograms from shared
//     memory; no global atomics, no scratch.  Large streams: up to one
//     block an SM, grid-stride.  Each block writes its 2B partial bins to
//     the wrapper's scratch and takes a ticket (atomicAdd after
//     __threadfence); the block with the last ticket sums the partials in
//     a fixed order (block g into part g % P, the P parts then in order),
//     adds the input histograms and sets the ticket back to 0.  Every
//     block copies its share of the window.
// Replicas: a call may bin R independent streams at once (a Monte Carlo
// batch, core/montecarlo.py): every array then has a leading (R,) axis and
// widx is (R,).  blockIdx.y is the replica; each replica's blocks bin into
// its own histograms, window, partials and ticket, on the path its own
// grid (gridDim.x) gives it.  R = 1 is the single stream.  A batch's
// one-block path takes blocks only as wide as its streams need (at least
// 128 threads, telemetry_bin.py plan), so R small histograms do not each
// hold a 1,024-thread block.
// With 0/1 weights every count and partial sum is an integer below 2^24,
// so no order of the atomics can show and both paths equal the plain
// version bit for bit.  The scratch and the ticket are one set per
// device, owned by the wrapper: two large-stream launches that overlap on
// two streams of one device would share them (telemetry_bin.py says so).

#include <cuda_runtime.h>
#include <stdint.h>

#define TB_THREADS 1024

__device__ __forceinline__ int log_bin(float v, float lo, float inv_lo,
                                       float scale, int n_bins) {
    const float raw = __fmul_rn(logf(__fmul_rn(fmaxf(v, lo), inv_lo)),
                                scale);
    // clamping before the truncating cast is the same map as the
    // reference's cast-then-clip and cannot overflow the integer
    return (int)fminf(fmaxf(raw, 0.0f), (float)(n_bins - 1));
}

// Weight w (not 0) of a value in bin b: counted when it is 1, summed as a
// float otherwise.
__device__ __forceinline__ void bin_add(float* sh, int* cnt, int b,
                                        float w) {
    if (w == 1.0f) atomicAdd(&cnt[b], 1);
    else atomicAdd(&sh[b], w);
}

__global__ void __launch_bounds__(TB_THREADS, 1)
telemetry_bin_kernel(const float* __restrict__ job_vals,
                     const float* __restrict__ job_wts, int n_job,
                     const float* __restrict__ task_vals,
                     const float* __restrict__ task_wts, int n_task,
                     float lo, float inv_lo, float scale, int n_bins,
                     const float* __restrict__ job_hist,
                     const float* __restrict__ task_hist,
                     const float* __restrict__ win, int n_win, int n_cols,
                     const int* __restrict__ widx,
                     const float* __restrict__ wvals,
                     float* __restrict__ job_out,
                     float* __restrict__ task_out,
                     float* __restrict__ win_out,
                     float* partial, unsigned int* ticket) {
    // [0, B) job bins, [B, 2B) task bins: the float parts, then the counts
    extern __shared__ float sh[];
    __shared__ float part_sum[TB_THREADS];
    __shared__ bool last;
    const int nb2 = 2 * n_bins;
    int* cnt = reinterpret_cast<int*>(sh + nb2);
    const int n = n_job > n_task ? n_job : n_task;
    const bool one_block = gridDim.x == 1;
    // this block's replica: its streams, histograms, window and scratch
    const int rep = blockIdx.y;
    job_vals += (long)rep * n_job;
    job_wts += (long)rep * n_job;
    task_vals += (long)rep * n_task;
    task_wts += (long)rep * n_task;
    job_hist += (long)rep * n_bins;
    task_hist += (long)rep * n_bins;
    job_out += (long)rep * n_bins;
    task_out += (long)rep * n_bins;
    win += (long)rep * n_win * n_cols;
    win_out += (long)rep * n_win * n_cols;
    widx += rep;
    wvals += (long)rep * n_cols;
    if (!one_block) {
        partial += (long)rep * gridDim.x * nb2;
        ticket += rep;
    }

    // the first round trip: this thread's first value and weight of each
    // stream (past a stream's end the weight reads 0), on the one-block
    // path its input bin, the window row index and its share of the window
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    float jw = i < n_job ? job_wts[i] : 0.0f;
    float jv = i < n_job ? job_vals[i] : 0.0f;
    float tw = i < n_task ? task_wts[i] : 0.0f;
    float tv = i < n_task ? task_vals[i] : 0.0f;
    const int b0 = threadIdx.x;
    const float hist0 = !one_block || b0 >= nb2 ? 0.0f
        : b0 < n_bins ? job_hist[b0] : task_hist[b0 - n_bins];
    const int r = *widx;
    for (int b = threadIdx.x; b < nb2; b += blockDim.x) {
        sh[b] = 0.0f;
        cnt[b] = 0;
    }
    const int n_w = n_win * n_cols;          // < 2^31 (plan)
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n_w;
         k += gridDim.x * blockDim.x)
        win_out[k] = k / n_cols == r ? __fadd_rn(win[k], wvals[k % n_cols])
                                     : win[k];
    __syncthreads();                 // the bins are zero

    // bin the values in hand (weights of 0 skipped before the log), then
    // load the next ones, grid-stride
    for (;;) {
        if (jw != 0.0f)
            bin_add(sh, cnt, log_bin(jv, lo, inv_lo, scale, n_bins), jw);
        if (tw != 0.0f)
            bin_add(sh, cnt, n_bins + log_bin(tv, lo, inv_lo, scale, n_bins),
                    tw);
        i += gridDim.x * blockDim.x;
        if (i >= n) break;
        jw = i < n_job ? job_wts[i] : 0.0f;
        jv = i < n_job ? job_vals[i] : 0.0f;
        tw = i < n_task ? task_wts[i] : 0.0f;
        tv = i < n_task ? task_vals[i] : 0.0f;
    }
    __syncthreads();
    // a bin's total: its float part plus its count (each thread its own
    // bins, so no barrier is needed before it reads them back)
    for (int b = threadIdx.x; b < nb2; b += blockDim.x)
        sh[b] = __fadd_rn(sh[b], (float)cnt[b]);

    if (one_block) {                 // small streams: straight out
        for (int b = threadIdx.x; b < nb2; b += blockDim.x) {
            const float h = b == b0 ? hist0
                : b < n_bins ? job_hist[b] : task_hist[b - n_bins];
            if (b < n_bins) job_out[b] = __fadd_rn(h, sh[b]);
            else task_out[b - n_bins] = __fadd_rn(h, sh[b]);
        }
        return;
    }

    // large streams: publish this block's bins, take a ticket
    float* mine = partial + (long)blockIdx.x * nb2;
    for (int b = threadIdx.x; b < nb2; b += blockDim.x) mine[b] = sh[b];
    __threadfence();                 // the bins are visible before the ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;

    // the last block: P parts of each bin, block g summed into part g % P
    // in block order, then the parts in order; the partials, written from
    // other SMs, are read from L2 (__ldcg)
    const int parts = nb2 < (int)blockDim.x ? blockDim.x / nb2 : 1;
    for (int t = threadIdx.x; t < parts * nb2; t += blockDim.x) {
        const int b = t % nb2, p = t / nb2;
        float s = 0.0f;
#pragma unroll 8
        for (int g = p; g < gridDim.x; g += parts)
            s += __ldcg(partial + (long)g * nb2 + b);
        if (parts > 1) part_sum[t] = s;   // t < blockDim.x here
        else if (b < n_bins) job_out[b] = __fadd_rn(job_hist[b], s);
        else task_out[b - n_bins] = __fadd_rn(task_hist[b - n_bins], s);
    }
    if (parts > 1) {
        __syncthreads();
        for (int b = threadIdx.x; b < nb2; b += blockDim.x) {
            float s = part_sum[b];
            for (int p = 1; p < parts; ++p) s += part_sum[p * nb2 + b];
            if (b < n_bins) job_out[b] = __fadd_rn(job_hist[b], s);
            else task_out[b - n_bins] = __fadd_rn(task_hist[b - n_bins], s);
        }
    }
    if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch
}

extern "C" int telemetry_bin_launch(
        const float* job_vals, const float* job_wts, int n_job,
        const float* task_vals, const float* task_wts, int n_task,
        float lo, float inv_lo, float scale, int n_bins,
        const float* job_hist, const float* task_hist,
        const float* win, int n_win, int n_cols,
        const int* widx, const float* wvals,
        float* job_out, float* task_out, float* win_out,
        float* partial, unsigned int* ticket, int grid, int reps, int block,
        void* stream) {
    if (n_bins <= 0 || n_job < 0 || n_task < 0 || n_win < 0 || n_cols < 0
            || grid <= 0 || reps <= 0 || reps > 65535 || block <= 0
            || block > TB_THREADS || block % 32 != 0
            || (grid > 1 && (partial == nullptr || ticket == nullptr)))
        return (int)cudaErrorInvalidValue;
    // two B-bin histograms of float parts and two of counts
    const size_t smem = 4 * (size_t)n_bins * sizeof(float);
    telemetry_bin_kernel<<<dim3(grid, reps), block, smem,
                           (cudaStream_t)stream>>>(
        job_vals, job_wts, n_job, task_vals, task_wts, n_task, lo, inv_lo,
        scale, n_bins, job_hist, task_hist, win, n_win, n_cols, widx, wvals,
        job_out, task_out, win_out, partial, ticket);
    return (int)cudaGetLastError();
}
