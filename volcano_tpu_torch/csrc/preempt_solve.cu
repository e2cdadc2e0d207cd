// K9: the whole preempt action as ONE persistent CTA.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:607 `preempt_solve`
// (preempt.go:45-273): for each queue in discovery order, phase 1 pops the
// best under-request job and drains its pending tasks through same-queue,
// cross-job attempts under a statement — committed when the gang reaches
// JobPipelined, discarded otherwise — then phase 2 runs within-job attempts
// over every under-request job.
//
// What bounds it on the H100: latency, as K8: a chain of dependent
// attempts, each a few passes over the pool and one over the nodes.
// Design: the setup kernels of victim_common.cuh, then one 1024-thread CTA
// runs the state machine (select / drain / within-job) on thread 0 and
// every attempt's node walk on all threads.  The JAX loop checkpoints its
// immutable state at each job pop and selects it back on discard; here
// thread 0 records the old value of every word an attempt writes inside a
// phase-1 statement (an undo journal, a few dozen words an attempt) and
// writes them back, newest first, on discard.  A journal that would
// overflow sets an error word the wrapper raises on.
#include "victim_common.cuh"

struct VttPreemptCtl {
  int phase;  // 0 select, 1 drain the popped job, 2 within-job
  int qpos, cur, j2pos;
  int assigned, last_v, any_p1, att_total, ck_att;
  int go, do_att, t, jt, qm;
};

// the popped job's statement ends: discard unless the gang pipelined; the
// job stays available only when it pipelined and placed something
__device__ void vtt_finish_job(const VttVictimArgs& a, VttPreemptCtl& c, VttJournal& jr) {
  const int j = c.cur;
  const bool pip = !a.gang_pipelined || a.job_occupied[j] + a.pipe[j] >= a.job_min[j];
  if (!pip) {
    vtt_jrestore(a, jr);
    a.ctl[VC_ATT] = c.ck_att;
  }
  a.job_avail[j] = (pip && c.assigned) ? 1 : 0;
  c.phase = 0;
  jr.on = false;
  jr.len = 0;
}

__global__ void __launch_bounds__(VTT_VICTIM_THREADS)
    vtt_preempt_kernel(VttVictimArgs a) {
  __shared__ VttCoreShared sh;
  __shared__ VttVJobKey s_key[VTT_VICTIM_THREADS];
  __shared__ VttAttempt s_at;
  __shared__ VttPreemptCtl c;

  const int tid = threadIdx.x;
  const int J = (int)a.J, Q = (int)a.Q, T = (int)a.T;
  const int nu = (int)a.nu, nq = (int)a.nq;
  const long long cap = 4LL * T + 4LL * J + (long long)nq * (nu + 4) + 64;
  VttJournal jr{false, 0};
  if (tid == 0) {
    c.phase = c.qpos = c.cur = c.j2pos = 0;
    c.assigned = c.last_v = c.any_p1 = c.att_total = c.ck_att = 0;
  }
  long long iters = 0;
  for (;; ++iters) {
    if (tid == 0) c.go = !a.ctl[VC_ABORT] && c.qpos < nq && iters < cap;
    __syncthreads();
    // every thread reads go and phase before thread 0 moves them
    const bool go = c.go;
    const int phase = c.phase;
    __syncthreads();
    if (!go) break;
    if (phase == 0) {
      const int q = a.queues_order[vtt_clamp(c.qpos, 0, Q - 1)];
      const int j = vtt_select_job(a, q, s_key);
      if (tid == 0) {
        c.do_att = 0;
        if (j >= 0) {
          c.cur = j;
          c.assigned = 0;
          a.job_avail[j] = 0;
          // the statement's checkpoint
          jr.on = true;
          jr.len = 0;
          c.ck_att = a.ctl[VC_ATT];
          c.phase = 1;
        } else {
          c.phase = 2;
          c.j2pos = 0;
        }
      }
    } else if (tid == 0) {
      if (phase == 1) {
        const int j = c.cur;
        const bool exhausted = a.cursor[j] >= a.job_ntasks[j];
        const int t = vtt_clamp(a.job_start[j] + a.cursor[j], 0, T - 1);
        c.do_att = !exhausted && a.task_attempt[t];
        c.t = t;
        c.jt = j;
        c.qm = 1;
        if (!exhausted)
          a.cursor[j] += 1;
        else
          vtt_finish_job(a, c, jr);
      } else {
        const bool done = c.j2pos >= nu;
        const int j = a.under_request[vtt_clamp(c.j2pos, 0, J - 1)];
        const bool exhausted = a.cursor[j] >= a.job_ntasks[j];
        const int t = vtt_clamp(a.job_start[j] + a.cursor[j], 0, T - 1);
        c.do_att = !done && !exhausted && a.task_attempt[t];
        c.t = t;
        c.jt = j;
        c.qm = 0;
        if (done) {
          c.qpos += 1;
          c.phase = 0;
        } else if (exhausted) {
          c.j2pos += 1;
        } else {
          a.cursor[j] += 1;
        }
      }
    }
    __syncthreads();
    if (!c.do_att) continue;
    if (tid == 0) vtt_attempt_init(a, s_at, c.t, c.jt, c.qm ? 0 : 1);
    __syncthreads();
    int nstar;
    bool clean;
    vtt_core(a, s_at, sh, nstar, clean);
    if (tid == 0) {
      const bool ok = nstar >= 0 && clean;
      if (!clean) a.ctl[VC_ABORT] = 1;
      if (ok) {
        const int nv = vtt_apply(a, s_at, nstar, jr);
        c.att_total += 1;
        if (c.qm) {
          c.assigned = 1;
          c.last_v = nv;
          c.any_p1 = 1;
        }
      }
      // phase 2 stops a job's drain at its first failed attempt
      if (!c.qm && clean && nstar < 0) c.j2pos += 1;
      // phase 1 checks JobPipelined after every attempt, ok or not
      const int jt = c.jt;
      if (c.qm && clean &&
          (!a.gang_pipelined || a.job_occupied[jt] + a.pipe[jt] >= a.job_min[jt]))
        vtt_finish_job(a, c, jr);
    }
    __syncthreads();
  }
  if (tid == 0) {
    a.ctl[VC_ATT_TOTAL] = c.att_total;
    a.ctl[VC_LAST_V] = c.last_v;
    a.ctl[VC_ANY] = c.any_p1;
    a.ctl[VC_ITERS] = (int)iters;
    if (c.qpos < nq) a.ctl[VC_ABORT] = 1;
  }
}

extern "C" int vtt_preempt_solve(const VttVictimArgs* args, void* stream) {
  const VttVictimArgs a = *args;
  if (a.R < 2 || a.R > VTT_MAX_R || a.n_keys > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_victim_setup(a, VTT_EV_PREEMPT, s);
  if (err) return err;
  VTT_LAUNCH(vtt_preempt_kernel, 1, VTT_VICTIM_THREADS, 0, s)(a);
  return (int)cudaGetLastError();
}
