// Fused latency-histogram binning for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/telemetry_bin.py
// (telemetry_accum, body _kernel), which bins blocks of latencies by a
// one-hot compare against the bin iota and keeps both histograms and the
// window matrix resident in VMEM across a sequential grid.
//
// Computes, on outputs the wrapper has already initialised with copies of
// the inputs:
//   job_hist[bin(job_vals[i])]   += job_wts[i]    for i < n_job
//   task_hist[bin(task_vals[i])] += task_wts[i]   for i < n_task
//   win[widx, :]                 += wvals          (dropped if widx is out
//                                                   of range)
// with bin(v) = clip(int(logf(max(v, lo) / lo) * scale), 0, n_bins - 1):
// the same three roundings, in the same order, as the plain version
// (kernels/ref.py log_bin): IEEE division, logf (not __logf; the build
// uses no --use_fast_math), a rounded multiply.
//
// What bounds it: launch latency.  The engine calls it once per macro-step
// with the full job stream (J,) and task stream (J*T,) and 0/1 weights:
// (J + J*T) * 8 bytes, about 10 KB at J = 600, next to nothing for the
// card.  The design keeps it to one launch: a grid-stride pass over both
// streams, each block accumulating two private B-bin histograms in shared
// memory with atomicAdd, then adding them into the outputs with one
// atomicAdd per non-zero bin.  Values with weight 0 (jobs that did not
// finish this step) are skipped before the log, so the shared-memory
// atomics see only the few real finishes.  With 0/1 weights every partial
// sum is an integer below 2^24, so the result does not depend on the order
// of the atomics and equals the plain version bit for bit.  Block 0 adds
// the window row.

#include <cuda_runtime.h>
#include <stdint.h>

#define TB_THREADS 256
#define TB_MAX_BLOCKS 264            // two waves of the H100's 132 SMs

__device__ __forceinline__ int log_bin(float v, float lo, float scale,
                                       int n_bins) {
    const float raw = __fmul_rn(logf(__fdiv_rn(fmaxf(v, lo), lo)), scale);
    // clamping before the truncating cast is the same map as the
    // reference's cast-then-clip and cannot overflow the integer
    return (int)fminf(fmaxf(raw, 0.0f), (float)(n_bins - 1));
}

__global__ void __launch_bounds__(TB_THREADS)
telemetry_bin_kernel(const float* __restrict__ job_vals,
                     const float* __restrict__ job_wts, int n_job,
                     const float* __restrict__ task_vals,
                     const float* __restrict__ task_wts, int n_task,
                     float lo, float scale, int n_bins,
                     float* __restrict__ job_hist,
                     float* __restrict__ task_hist,
                     float* __restrict__ win, int n_win, int n_cols,
                     const int* __restrict__ widx,
                     const float* __restrict__ wvals) {
    extern __shared__ float sh[];    // [0, B) job bins, [B, 2B) task bins
    float* sh_job = sh;
    float* sh_task = sh + n_bins;
    for (int b = threadIdx.x; b < 2 * n_bins; b += blockDim.x) sh[b] = 0.0f;
    __syncthreads();

    const int n = n_job > n_task ? n_job : n_task;
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        if (i < n_job) {
            const float w = job_wts[i];
            if (w != 0.0f)
                atomicAdd(&sh_job[log_bin(job_vals[i], lo, scale, n_bins)], w);
        }
        if (i < n_task) {
            const float w = task_wts[i];
            if (w != 0.0f)
                atomicAdd(&sh_task[log_bin(task_vals[i], lo, scale, n_bins)],
                          w);
        }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
        if (sh_job[b] != 0.0f) atomicAdd(&job_hist[b], sh_job[b]);
        if (sh_task[b] != 0.0f) atomicAdd(&task_hist[b], sh_task[b]);
    }
    if (blockIdx.x == 0) {
        const int r = *widx;
        if (r >= 0 && r < n_win)
            for (int k = threadIdx.x; k < n_cols; k += blockDim.x)
                win[(long)r * n_cols + k] =
                    __fadd_rn(win[(long)r * n_cols + k], wvals[k]);
    }
}

extern "C" int telemetry_bin_launch(
        const float* job_vals, const float* job_wts, int n_job,
        const float* task_vals, const float* task_wts, int n_task,
        float lo, float scale, int n_bins,
        float* job_hist, float* task_hist,
        float* win, int n_win, int n_cols,
        const int* widx, const float* wvals, void* stream) {
    if (n_bins <= 0 || n_job < 0 || n_task < 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)n_bins * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int n = n_job > n_task ? n_job : n_task;
    int blocks = (n + TB_THREADS - 1) / TB_THREADS;
    blocks = blocks < 1 ? 1 : (blocks > TB_MAX_BLOCKS ? TB_MAX_BLOCKS : blocks);
    telemetry_bin_kernel<<<blocks, TB_THREADS, smem, (cudaStream_t)stream>>>(
        job_vals, job_wts, n_job, task_vals, task_wts, n_task, lo, scale,
        n_bins, job_hist, task_hist, win, n_win, n_cols, widx, wvals);
    return (int)cudaGetLastError();
}
