// K8: the whole reclaim action as ONE persistent CTA.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:457 `reclaim_solve`
// (reclaim.go:42-201): pop the queue with the lowest proportion share, pop
// its best job once, attempt that job's head task against the running
// tasks of every other queue, and re-arm the queue only on success.
//
// What bounds it on the H100: latency.  Every attempt depends on the state
// the one before it left, so the action is a chain of at most 2 (J + Q) + 64
// steps; a step walks the pool once per pass (about 3 passes of V rows,
// 20-30 bytes a row, from L2) and scores the valid nodes.  Design: the
// setup kernels group the pool by node once per launch (victim_common.cuh);
// then one 1024-thread CTA runs the loop, threads owning strided nodes, with
// the queue and job choice and the state update on thread 0.  An attempt
// that is not clean (the reference's walk would strand evictions) stops the
// loop with the abort flag set, as the JAX loop does.
#include "victim_common.cuh"

__global__ void __launch_bounds__(VTT_VICTIM_THREADS)
    vtt_reclaim_kernel(VttVictimArgs a) {
  __shared__ VttCoreShared sh;
  __shared__ VttVJobKey s_key[VTT_VICTIM_THREADS];
  __shared__ VttAttempt s_at;
  __shared__ int s_go, s_q, s_over;

  const int tid = threadIdx.x;
  const int J = (int)a.J, Q = (int)a.Q, T = (int)a.T, R = (int)a.R;
  const int cap = 2 * (J + Q) + 64;
  VttJournal jr{false, 0};
  int iters = 0;
  for (;; ++iters) {
    if (tid == 0) {
      bool any_q = false;
      for (int q = 0; q < Q; ++q) any_q = any_q || a.queue_live[q];
      s_go = !a.ctl[VC_ABORT] && any_q && iters < cap;
      if (s_go) {
        int qstar = -1;
        float best = VTT_POS_INF;
        for (int q = 0; q < Q; ++q) {
          if (!a.queue_live[q]) continue;
          const float share =
              a.has_proportion
                  ? vtt_dominant_share(&a.queue_alloc[(size_t)q * R],
                                       &a.queue_deserved[(size_t)q * R], R)
                  : 0.0f;
          if (qstar < 0 || share < best) {
            best = share;
            qstar = q;
          }
        }
        s_q = qstar;
        s_over = a.has_proportion &&
                 vtt_less_equal(&a.queue_deserved[(size_t)qstar * R],
                                &a.queue_alloc[(size_t)qstar * R], a.eps, R);
      }
    }
    __syncthreads();
    if (!s_go) break;
    const int qstar = s_q;
    const int j = s_over ? -1 : vtt_select_job(a, qstar, s_key);
    if (j < 0) {
      // nothing to take from this queue: it leaves the priority queue
      if (tid == 0) a.queue_live[qstar] = 0;
      __syncthreads();
      continue;
    }
    if (tid == 0) vtt_attempt_init(a, s_at, vtt_clamp(a.job_start[j], 0, T - 1), j, 2);
    __syncthreads();
    int nstar;
    bool clean;
    vtt_core(a, s_at, sh, nstar, clean);
    if (tid == 0) {
      const bool ok = nstar >= 0 && clean;
      a.job_avail[j] = 0;
      a.queue_live[qstar] = ok ? 1 : 0;
      if (ok) vtt_apply(a, s_at, nstar, jr);
      if (!clean) a.ctl[VC_ABORT] = 1;
    }
    __syncthreads();
  }
  if (tid == 0) {
    a.ctl[VC_ITERS] = iters;
    if (iters >= cap) a.ctl[VC_ABORT] = 1;
  }
}

extern "C" int vtt_reclaim_solve(const VttVictimArgs* args, void* stream) {
  const VttVictimArgs a = *args;
  if (a.R < 2 || a.R > VTT_MAX_R || a.n_keys > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_victim_setup(a, VTT_EV_RECLAIM, s);
  if (err) return err;
  VTT_LAUNCH(vtt_reclaim_kernel, 1, VTT_VICTIM_THREADS, 0, s)(a);
  return (int)cudaGetLastError();
}
