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
//     cell and 9 a queue (above 1,024 queues 4 more a window of 32 queues
//     for each of phase B's R + 1 sums), at most VTT_WF_MAX_CELLS cells;
//   * two barriers a round.  Phase A, a thread per queue: the grant, the
//     capped cells, the exceeded test and the met flag, each queue's
//     deltas (capped - deserved) and its next-round weight (0 once met)
//     written beside them.  Phase B, a warp a sum: warp r < R sums
//     dimension r's deltas, and warp R the next round's live weights, each
//     over queues in the reference's order, which is XLA's window order
//     (scheduler/kernels.py window_sum0: the axis padded with zeros to a
//     multiple of 32, floor(pad / 2) in front, each window of 32 summed in
//     index order, again on the partials until 32 or fewer remain, then
//     those in index order).  Lane w sums window w, so up to 32 windows
//     are summed side by side, and the lanes' partials are then added in
//     index order through shuffles; above 1,024 queues (up to 8,192 at
//     R = 1) the first level's partials go to shared memory and a second
//     level of windows sums them.  K2, K3 and K7 consume these shares bit
//     for bit, so the order is the reference's and no other: the serial
//     chain a round is about 32 + Q / 32 adds (64 at 1,024 queues) where
//     index order took Q.  Every thread then reads the stop test itself;
//   * the round count (or -1 when the loop stopped at max_rounds, which
//     the reference has no cap for) goes to a host word by an asynchronous
//     copy on the stream, which the wrapper checks where its consumers wait
//     on the stream (scheduler/kernels.py water_fill_check).
#include "common.cuh"

#define VTT_WF_THREADS 1024
// the most (queue, dim) cells the kernel takes: 25 bytes a cell at R = 1
// (the worst case) and 2 KB of partials fill 202 KB of the CTA's 227 KB of
// shared memory
#define VTT_WF_MAX_CELLS 8192

// the width of the reference's summing windows, and the most first-level
// partials (windows) a sum over VTT_WF_MAX_CELLS queues has: two levels
// of windows reach the final lane sum
#define VTT_WF_WIN 32
#define VTT_WF_MAX_WIN (VTT_WF_MAX_CELLS / VTT_WF_WIN)
static_assert(VTT_WF_MAX_WIN <= VTT_WF_WIN * VTT_WF_WIN, "two levels of windows");

// Window w of x[0], x[stride], .., x[(n - 1) * stride] padded with zeros to
// a multiple of 32, floor(pad / 2) of them in front: its 32 values added in
// index order from 0.0f, the padding's zeros included
__device__ __forceinline__ float vtt_wf_window(const float* x, int n, int stride, int w) {
  const int nw = (n + VTT_WF_WIN - 1) / VTT_WF_WIN;
  const int base = w * VTT_WF_WIN - (nw * VTT_WF_WIN - n) / 2;
  float b[VTT_WF_WIN];
#pragma unroll
  for (int j = 0; j < VTT_WF_WIN; ++j) {
    const int i = base + j;
    b[j] = (i >= 0 && i < n) ? x[i * stride] : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < VTT_WF_WIN; ++j) acc = acc + b[j];
  return acc;
}

// Lanes 0 .. n - 1's values (n <= 32) added in index order from 0.0f, on
// every lane of the warp
__device__ __forceinline__ float vtt_wf_lane_sum(float v, int n) {
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) acc = acc + __shfl_sync(0xffffffffu, v, j);
  return acc;
}

// The first-level partials a sum over n values keeps in shared memory: none
// up to 1,024 values (32 windows, in the lanes' registers), else a window
// each (at most VTT_WF_MAX_WIN)
__host__ __device__ __forceinline__ int vtt_wf_part_len(int n) {
  return n > VTT_WF_WIN * VTT_WF_WIN ? (n + VTT_WF_WIN - 1) / VTT_WF_WIN : 0;
}

// x[0] + x[stride] + ... + x[(n - 1) * stride] in the reference's window
// order, by the whole warp (lane = its lane), on every lane; part holds
// vtt_wf_part_len(n) floats for the first level's partials above 1,024
// values
__device__ float vtt_wf_window_sum(const float* x, int n, int stride, float* part, int lane) {
  if (n <= VTT_WF_WIN) return vtt_wf_lane_sum(lane < n ? x[lane * stride] : 0.0f, n);
  const int nw = (n + VTT_WF_WIN - 1) / VTT_WF_WIN;
  if (nw <= VTT_WF_WIN)
    return vtt_wf_lane_sum(lane < nw ? vtt_wf_window(x, n, stride, lane) : 0.0f, nw);
  for (int w = lane; w < nw; w += VTT_WF_WIN) part[w] = vtt_wf_window(x, n, stride, w);
  __syncwarp();
  const int nw2 = (nw + VTT_WF_WIN - 1) / VTT_WF_WIN;
  const float p = lane < nw2 ? vtt_wf_window(part, nw, 1, lane) : 0.0f;
  __syncwarp();
  return vtt_wf_lane_sum(p, nw2);
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
  const int nw1 = vtt_wf_part_len(Q);            // a sum's first-level partials
  float* s_part = s_wnext + Q;                   // (R + 1) x nw1 of them
  uint8_t* s_live = reinterpret_cast<uint8_t*>(s_part + (R + 1) * nw1);  // participates && !met
  __shared__ float s_rem[VTT_MAX_R];
  __shared__ float s_eps[VTT_MAX_R];
  __shared__ float s_tw;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
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
  if (warp == 0) {
    const float tw0 = vtt_wf_window_sum(s_wnext, Q, 1, s_part + R * nw1, lane);
    if (lane == 0) s_tw = tw0;
  }
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
    // phase B: a warp a dimension's deltas and one for the weights
    for (int k = warp; k <= R; k += nwarps) {  // warp-uniform
      const float sum = vtt_wf_window_sum(k < R ? s_delta + k : s_wnext, Q, k < R ? R : 1,
                                          s_part + k * nw1, lane);
      if (lane == 0) {
        if (k < R)
          s_rem[k] = s_rem[k] - sum;
        else
          s_tw = sum;
      }
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
  return (size_t)Q * R * 4 * sizeof(float) + (size_t)Q * (2 * sizeof(float) + 1) +
         (size_t)(R + 1) * vtt_wf_part_len(Q) * sizeof(float);
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
  // a thread a queue, and a warp for each of phase B's R + 1 sums
  int threads = 32;
  while ((threads < Q || threads < 32 * (R + 1)) && threads < VTT_WF_THREADS) threads *= 2;
  VTT_LAUNCH(vtt_water_fill_kernel, 1, threads, smem, s)(
      weight, request, total, eps, participates, Q, R, max_rounds, deserved, rounds_dev);
  int err = (int)cudaGetLastError();
  if (!err)
    err = (int)cudaMemcpyAsync(rounds_host, rounds_dev, sizeof(int32_t),
                               cudaMemcpyDeviceToHost, s);
  return err;
}
