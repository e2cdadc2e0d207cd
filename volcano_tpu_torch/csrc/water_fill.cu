// K1: proportion water-filling on one CTA.
//
// Replaces volcano_tpu/scheduler/kernels.py:73 `water_fill` (a jitted
// lax.while_loop).  Bound on the H100: neither bytes (Q*R floats, a few
// hundred bytes) nor operations (a few per queue per round) — the launch
// and the round loop's barriers are the whole cost.  Design: one CTA whose
// threads own one (queue, dim) cell each; the round loop runs inside the
// kernel, so the host pays one launch per cycle however many rounds the
// fill takes.  Sums over queues run in index order on one thread per
// dimension, as the reference's reduction does.  The reference loop has no
// cap; this one stops after max_rounds and writes -1 to *rounds_out, which
// the wrapper turns into an error (else it writes the rounds taken).
#include "common.cuh"

#define VTT_WF_MAX_CELLS 1024

__global__ void vtt_water_fill_kernel(const float* weight, const float* request,
                                      const float* total, const float* eps,
                                      const uint8_t* participates, int Q, int R,
                                      int max_rounds, float* deserved,
                                      int32_t* rounds_out) {
  __shared__ float s_des[VTT_WF_MAX_CELLS];
  __shared__ float s_cap[VTT_WF_MAX_CELLS];
  __shared__ float s_rem[VTT_MAX_R];
  __shared__ float s_eps[VTT_MAX_R];
  __shared__ uint8_t s_met[VTT_WF_MAX_CELLS];
  __shared__ uint8_t s_exc[VTT_WF_MAX_CELLS];
  __shared__ float s_tw;
  __shared__ int s_go;

  const int tid = threadIdx.x;
  const int cells = Q * R;
  const int q = tid / R, r = tid % R;
  const bool own = tid < cells;
  if (own) s_des[tid] = 0.0f;
  if (tid < Q) s_met[tid] = 0;
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
        tw = tw + ((participates[k] && !s_met[k]) ? weight[k] : 0.0f);
      s_tw = tw;
    }
    __syncthreads();
    const float tw = s_tw;
    float nd = 0.0f;
    if (own) {
      const bool live = participates[q] && !s_met[q];
      const float frac = tw > 0.0f ? weight[q] / fmaxf(tw, 1e-30f) : 0.0f;
      const float grant = live ? s_rem[r] * frac : 0.0f;
      nd = s_des[tid] + grant;
      s_cap[tid] = nd;
    }
    __syncthreads();
    if (tid < Q) {
      const bool live = participates[tid] && !s_met[tid];
      bool le = true;
      for (int k = 0; k < R; ++k)
        le = le && (s_cap[tid * R + k] < request[tid * R + k] + s_eps[k]);
      s_exc[tid] = (!le && live) ? 1 : 0;
    }
    __syncthreads();
    if (own && s_exc[q]) s_cap[tid] = fminf(nd, request[tid]);
    __syncthreads();
    if (tid < R) {
      float delta = 0.0f;
      for (int k = 0; k < Q; ++k)
        delta = delta + (s_cap[k * R + tid] - s_des[k * R + tid]);
      s_rem[tid] = s_rem[tid] - delta;
    }
    __syncthreads();
    if (own) s_des[tid] = s_cap[tid];
    if (tid < Q) s_met[tid] = s_met[tid] | s_exc[tid];
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
  if (own) deserved[tid] = s_des[tid];
  if (tid == 0) *rounds_out = taken;
}

extern "C" int vtt_water_fill(const float* weight, const float* request,
                              const float* total, const float* eps,
                              const uint8_t* participates, int Q, int R,
                              int max_rounds, float* deserved, int32_t* rounds_out,
                              void* stream) {
  if (Q < 1 || R < 1 || R > VTT_MAX_R || Q * R > VTT_WF_MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  int threads = 32;
  while (threads < Q * R) threads *= 2;
  VTT_LAUNCH(vtt_water_fill_kernel, 1, threads, 0, (cudaStream_t)stream)(
      weight, request, total, eps, participates, Q, R, max_rounds, deserved, rounds_out);
  return (int)cudaGetLastError();
}
