// K7: one preemptor's victim solve over all nodes, as one launch.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:362 `victim_step` (core
// :118-355), the standalone victim solve that the object path's preempt and
// reclaim drive once per preemptor (tensor_actions._VictimDriver): the base
// mask by mode (0 queue: same queue, other jobs; 1 job: own job; 2
// reclaim: other queues), the per-node drf / proportion / eviction orders,
// the gang, drf, proportion and conformance vetoes, the DO-while victim
// prefix, the best node of the walk and the state update.
//
// What bounds it on the H100: latency.  The work is a few passes over the
// pool (about 30 bytes a row) and a score per node, microseconds of
// traffic at 3.35 TB/s; the launch chain (four setup kernels, the core, the
// pack) and the host's one fetch per attempt dominate.  Design: the setup
// kernels of victim_common.cuh group the pool by node and rank each row in
// its node's orders (recomputed every call, as the JAX function does); one
// 1024-thread CTA runs vtt_core (threads own strided nodes; block-wide
// lexicographic argmins give the first covered and first valid node), and
// thread 0 applies the decision with vtt_apply to the wrapper's copy of the
// state whenever a node is covered, clean or not, as the JAX function
// returns its updated state either way.  The last kernel packs the result
// into one int32 buffer: assigned, nstar (0 when unassigned), clean, the
// victim count, then the victim mask as ceil(V / 32) words.
#include "victim_common.cuh"

__global__ void __launch_bounds__(VTT_VICTIM_THREADS)
    vtt_victim_step_kernel(VttVictimArgs a, int t_cls, int jt, int qt, int mode,
                           int32_t* out) {
  __shared__ VttCoreShared sh;
  __shared__ VttAttempt s_at;
  const int tid = threadIdx.x;
  const int R = (int)a.R;
  if (tid == 0) {
    VttAttempt& at = s_at;
    at.t = 0;
    at.jt = jt;
    at.qt = qt;
    at.mode = mode;
    at.cls = t_cls;
    for (int r = 0; r < R; ++r) at.req[r] = a.task_req[r];
    at.ls = 0.0f;
    if (a.use_drf) {
      float sum[VTT_MAX_R];
      for (int r = 0; r < R; ++r) sum[r] = a.job_alloc[(size_t)jt * R + r] + at.req[r];
      at.ls = vtt_dominant_share(sum, a.total, R);
    }
  }
  __syncthreads();
  int nstar;
  bool clean;
  vtt_core(a, s_at, sh, nstar, clean);
  if (tid == 0) {
    VttJournal jr{false, 0};
    const int nv = nstar >= 0 ? vtt_apply(a, s_at, nstar, jr) : 0;
    out[0] = nstar >= 0;
    out[1] = nstar >= 0 ? nstar : 0;
    out[2] = clean;
    out[3] = nv;
  }
}

// victim mask words: bit v % 32 of word v / 32 is row v's eviction
static __global__ void vtt_victim_step_pack(VttVictimArgs a, int32_t* out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int nw = (int)((a.V + 31) / 32);
  if (w >= nw) return;
  uint32_t bits = 0;
  for (int b = 0; b < 32; ++b) {
    const long long v = (long long)w * 32 + b;
    if (v < a.V && a.evict_att[v] >= 0) bits |= 1u << b;
  }
  out[4 + w] = (int32_t)bits;
}

extern "C" int vtt_victim_step(const VttVictimArgs* args, int t_cls, int jt, int qt,
                               int mode, void* out, void* stream) {
  const VttVictimArgs a = *args;
  if (a.R < 2 || a.R > VTT_MAX_R || mode < 0 || mode > 2 || jt < 0 || jt >= a.J ||
      t_cls < 0 || t_cls >= a.C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_victim_setup(a, mode == 2 ? VTT_EV_RECLAIM : VTT_EV_PREEMPT, s);
  if (err) return err;
  int32_t* o = (int32_t*)out;
  VTT_LAUNCH(vtt_victim_step_kernel, 1, VTT_VICTIM_THREADS, 0, s)(a, t_cls, jt, qt, mode, o);
  const int nw = (int)((a.V + 31) / 32);
  VTT_LAUNCH(vtt_victim_step_pack, (nw + 255) / 256, 256, 0, s)(a, o);
  return (int)cudaGetLastError();
}
