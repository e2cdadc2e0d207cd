// K1: proportion water-filling on one CTA, its working cells in shared
// memory.
//
// Replaces volcano_tpu/scheduler/kernels.py:73 `water_fill` (a jitted
// lax.while_loop).  Bound on the H100: neither bytes (Q*R floats, a few
// hundred bytes at the cells' shapes) nor operations (a few per queue per
// round) -- the launch, the round loop's barriers and its serial sums are
// the whole cost.  Design:
//   * one CTA; the round loop runs inside the kernel, so the host pays one
//     launch per cycle however many rounds the fill takes;
//   * the working cells (deserved and the capped grants, double-buffered,
//     the requests and the deltas) and the per-queue weights and live
//     flags live in dynamic shared memory for the whole loop: 16 bytes a
//     cell and 9 a queue, at most VTT_WF_MAX_CELLS cells;
//   * two barriers a round.  Phase A, a thread per queue: the grant, the
//     capped cells, the exceeded test and the met flag, each queue's
//     deltas (capped - deserved) and its next-round weight (0 once met)
//     written beside them.  Phase B, one warp: lane r < R sums dimension
//     r's deltas, and lane R the next round's live weights, each over
//     queues in index order on one thread (the plain version's order: a
//     tree would change the float bits, and K2, K3 and K7 consume these
//     shares bit for bit), its loads issued in batches ahead of the adds.
//     Every thread then reads the stop test itself;
//   * the round count (or -1 when the loop stopped at max_rounds, which
//     the reference has no cap for) goes to a host word by an asynchronous
//     copy on the stream, which the wrapper checks where its consumers wait
//     on the stream (scheduler/kernels.py water_fill_check).
#include "common.cuh"

#define VTT_WF_THREADS 1024
// the most (queue, dim) cells the kernel takes: 25 bytes a cell at R = 1
// (the worst case) fill 200 KB of the CTA's 227 KB of shared memory
#define VTT_WF_MAX_CELLS 8192

// x[0] + x[stride] + ... + x[(n - 1) * stride] in index order, from 0.0f:
// batches of VTT_WF_BATCH loads issued together, then added one after the
// other (the add chain, not the loads' latency, sets the pace)
#define VTT_WF_BATCH 16
__device__ __forceinline__ float vtt_wf_seq_sum(const float* x, int n, int stride) {
  float acc = 0.0f;
  int k = 0;
  for (; k + VTT_WF_BATCH <= n; k += VTT_WF_BATCH) {
    float b[VTT_WF_BATCH];
#pragma unroll
    for (int j = 0; j < VTT_WF_BATCH; ++j) b[j] = x[(k + j) * stride];
#pragma unroll
    for (int j = 0; j < VTT_WF_BATCH; ++j) acc = acc + b[j];
  }
  for (; k < n; ++k) acc = acc + x[k * stride];
  return acc;
}

__global__ void __launch_bounds__(VTT_WF_THREADS)
    vtt_water_fill_kernel(const float* weight, const float* request, const float* total,
                          const float* eps, const uint8_t* participates, int Q, int R,
                          int max_rounds, float* deserved, int32_t* rounds_out) {
  VTT_DYN_SMEM(float, s_cells);
  const int cells = Q * R;
  float* s_des[2] = {s_cells, s_cells + cells};  // deserved, then the capped grants
  float* s_req = s_cells + 2 * cells;
  float* s_delta = s_cells + 3 * cells;          // capped - deserved
  float* s_w = s_cells + 4 * cells;              // weights
  float* s_wnext = s_w + Q;                      // the next round's live weights
  uint8_t* s_live = reinterpret_cast<uint8_t*>(s_wnext + Q);  // participates && !met
  __shared__ float s_rem[VTT_MAX_R];
  __shared__ float s_eps[VTT_MAX_R];
  __shared__ float s_tw;

  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int c = tid; c < cells; c += nthr) {
    s_des[0][c] = 0.0f;
    s_req[c] = request[c];
  }
  for (int q = tid; q < Q; q += nthr) {
    s_w[q] = weight[q];
    s_live[q] = participates[q] ? 1 : 0;
    s_wnext[q] = participates[q] ? weight[q] : 0.0f;
  }
  if (tid < R) {
    s_rem[tid] = total[tid];
    s_eps[tid] = eps[tid];
  }
  __syncthreads();
  if (tid == 0) s_tw = vtt_wf_seq_sum(s_wnext, Q, 1);
  __syncthreads();

  int taken = -1, cur = 0;
  for (int round = 0; round < max_rounds; ++round) {
    const float tw = s_tw;
    const float* des = s_des[cur];
    float* nxt = s_des[cur ^ 1];
    // phase A: a thread per queue
    for (int q = tid; q < Q; q += nthr) {
      const bool live = s_live[q];
      const float frac = tw > 0.0f ? s_w[q] / fmaxf(tw, 1e-30f) : 0.0f;
      float nd[VTT_MAX_R];
      bool le = true;
      for (int r = 0; r < R; ++r) {
        const float grant = live ? s_rem[r] * frac : 0.0f;
        nd[r] = des[q * R + r] + grant;
        le = le && (nd[r] < s_req[q * R + r] + s_eps[r]);
      }
      const bool exc = !le && live;
      for (int r = 0; r < R; ++r) {
        const float capped = exc ? fminf(nd[r], s_req[q * R + r]) : nd[r];
        nxt[q * R + r] = capped;
        s_delta[q * R + r] = capped - des[q * R + r];
      }
      if (exc) s_live[q] = 0;
      s_wnext[q] = live && !exc ? s_w[q] : 0.0f;
    }
    __syncthreads();
    // phase B: one warp, a lane a dimension and one for the weights
    if (tid <= R) {  // one instruction stream: the lanes do not diverge
      const float sum = vtt_wf_seq_sum(tid < R ? s_delta + tid : s_wnext, Q, tid < R ? R : 1);
      if (tid < R)
        s_rem[tid] = s_rem[tid] - sum;
      else
        s_tw = sum;
    }
    __syncthreads();
    cur ^= 1;
    bool empty = true;
    for (int r = 0; r < R; ++r) empty = empty && (s_rem[r] < s_eps[r]);
    if (!(tw > 0.0f) || empty) {
      taken = round + 1;
      break;
    }
  }
  for (int c = tid; c < cells; c += nthr) deserved[c] = s_des[cur][c];
  if (tid == 0) *rounds_out = taken;
}

// Bytes of dynamic shared memory for Q queues and R dims.
static inline size_t vtt_wf_smem(int Q, int R) {
  return (size_t)Q * R * 4 * sizeof(float) + (size_t)Q * (2 * sizeof(float) + 1);
}

// Launch the fill of deserved [Q, R] and copy its round word (a device
// int32) into *rounds_host (pinned) on the same stream; neither waits.
extern "C" int vtt_water_fill(const float* weight, const float* request,
                              const float* total, const float* eps,
                              const uint8_t* participates, int Q, int R,
                              int max_rounds, float* deserved, int32_t* rounds_dev,
                              int32_t* rounds_host, void* stream) {
  if (Q < 1 || R < 1 || R > VTT_MAX_R || Q * R > VTT_WF_MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = vtt_wf_smem(Q, R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vtt_water_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = 32;
  while (threads < Q && threads < VTT_WF_THREADS) threads *= 2;
  VTT_LAUNCH(vtt_water_fill_kernel, 1, threads, smem, s)(
      weight, request, total, eps, participates, Q, R, max_rounds, deserved, rounds_dev);
  int err = (int)cudaGetLastError();
  if (!err)
    err = (int)cudaMemcpyAsync(rounds_host, rounds_dev, sizeof(int32_t),
                               cudaMemcpyDeviceToHost, s);
  return err;
}
