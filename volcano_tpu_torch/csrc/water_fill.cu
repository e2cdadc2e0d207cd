// K1: proportion water-filling on one CTA.
//
// Replaces volcano_tpu/scheduler/kernels.py:73 `water_fill` (a jitted
// lax.while_loop).  Bound on the H100: neither bytes (Q*R floats, a few
// hundred bytes at the cells' shapes) nor operations (a few per queue per
// round) -- the launch and the round loop's barriers are the whole cost.
// Design: one CTA whose threads walk the (queue, dim) cells in strides of
// the block size, so any Q*R runs; the round loop runs inside the kernel,
// so the host pays one launch per cycle however many rounds the fill
// takes.  The working cells live in global scratch the wrapper allocates
// (deserved in the output itself, the capped grants and the per-queue met
// and exceeded flags beside it); a CTA's global writes are visible to its
// threads after __syncthreads.  Sums over queues run in index order on one
// thread per dimension, as the reference's reduction does.  The reference
// loop has no cap; this one stops after max_rounds and writes -1 to
// *rounds_out, which the wrapper turns into an error (else it writes the
// rounds taken).
#include "common.cuh"

#define VTT_WF_THREADS 1024

__global__ void __launch_bounds__(VTT_WF_THREADS)
    vtt_water_fill_kernel(const float* weight, const float* request, const float* total,
                          const float* eps, const uint8_t* participates, int Q, int R,
                          int max_rounds, float* des, float* cap, uint8_t* met,
                          uint8_t* exc, int32_t* rounds_out) {
  __shared__ float s_rem[VTT_MAX_R];
  __shared__ float s_eps[VTT_MAX_R];
  __shared__ float s_tw;
  __shared__ int s_go;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cells = Q * R;
  for (int c = tid; c < cells; c += nthr) des[c] = 0.0f;
  for (int q = tid; q < Q; q += nthr) met[q] = 0;
  if (tid < R) {
    s_rem[tid] = total[tid];
    s_eps[tid] = eps[tid];
  }
  __syncthreads();

  int taken = -1;
  for (int round = 0; round < max_rounds; ++round) {
    if (tid == 0) {
      float tw = 0.0f;
      for (int k = 0; k < Q; ++k)
        tw = tw + ((participates[k] && !met[k]) ? weight[k] : 0.0f);
      s_tw = tw;
    }
    __syncthreads();
    const float tw = s_tw;
    for (int c = tid; c < cells; c += nthr) {
      const int q = c / R, r = c % R;
      const bool live = participates[q] && !met[q];
      const float frac = tw > 0.0f ? weight[q] / fmaxf(tw, 1e-30f) : 0.0f;
      const float grant = live ? s_rem[r] * frac : 0.0f;
      cap[c] = des[c] + grant;
    }
    __syncthreads();
    for (int q = tid; q < Q; q += nthr) {
      const bool live = participates[q] && !met[q];
      bool le = true;
      for (int k = 0; k < R; ++k)
        le = le && (cap[q * R + k] < request[q * R + k] + s_eps[k]);
      exc[q] = (!le && live) ? 1 : 0;
    }
    __syncthreads();
    for (int c = tid; c < cells; c += nthr)
      if (exc[c / R]) cap[c] = fminf(cap[c], request[c]);
    __syncthreads();
    if (tid < R) {
      float delta = 0.0f;
      for (int k = 0; k < Q; ++k)
        delta = delta + (cap[k * R + tid] - des[k * R + tid]);
      s_rem[tid] = s_rem[tid] - delta;
    }
    __syncthreads();
    for (int c = tid; c < cells; c += nthr) des[c] = cap[c];
    for (int q = tid; q < Q; q += nthr) met[q] = met[q] | exc[q];
    if (tid == 0) {
      bool empty = true;
      for (int k = 0; k < R; ++k) empty = empty && (s_rem[k] < s_eps[k]);
      s_go = (tw > 0.0f) && !empty;
    }
    __syncthreads();
    if (!s_go) {
      taken = round + 1;
      break;
    }
  }
  if (tid == 0) *rounds_out = taken;
}

extern "C" int vtt_water_fill(const float* weight, const float* request,
                              const float* total, const float* eps,
                              const uint8_t* participates, int Q, int R,
                              int max_rounds, float* deserved, float* cap,
                              uint8_t* flags, int32_t* rounds_out, void* stream) {
  if (Q < 1 || R < 1 || R > VTT_MAX_R) return (int)cudaErrorInvalidValue;
  int threads = 32;
  while (threads < Q * R && threads < VTT_WF_THREADS) threads *= 2;
  VTT_LAUNCH(vtt_water_fill_kernel, 1, threads, 0, (cudaStream_t)stream)(
      weight, request, total, eps, participates, Q, R, max_rounds, deserved, cap,
      flags, flags + Q, rounds_out);
  return (int)cudaGetLastError();
}
