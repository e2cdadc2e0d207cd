// K9: the whole preempt action as ONE launch of one thread-block cluster;
// K15b: the same walk with the node planes in blocks.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:607 `preempt_solve`
// (preempt.go:45-273): for each queue in discovery order, phase 1 pops the
// best under-request job and drains its pending tasks through same-queue,
// cross-job attempts under a statement — committed when the gang reaches
// JobPipelined, discarded otherwise — then phase 2 runs within-job attempts
// over every under-request job.
//
// What bounds it on the H100: latency, as K8: a chain of dependent
// attempts (2,000 in cfg6's storm under solveMode: exact), each a few
// passes over every node's pool rows, through dependent loads.  Design:
// the setup kernels of victim_common.cuh group the pool by node once a
// solve; then vtt_walk_cluster (victim_common.cuh) runs the walk on one
// cluster of up to 16 CTAs x 1024 threads, one node a thread over row-
// balanced node ranges, two cluster barriers an attempt; rank 0 runs the
// state machine (select / drain / within-job) and applies.  The JAX loop
// checkpoints its immutable state at each job pop and selects it back on
// discard; here rank 0's thread 0 records the old value of every word an
// attempt writes inside a phase-1 statement (an undo journal, a few dozen
// words an attempt) and writes them back, newest first, on discard.  A
// journal that would overflow sets an error word the wrapper raises on.
//
// K15b replaces the same function under a mesh with solveMode: batch
// (volcano_tpu/scheduler/fast_victims.py:148-163, :191-198), as K15a does
// for K8 (reclaim_solve.cu): the state machine (vtt_pw_advance /
// vtt_pw_after) is the same device code with its state, the journal's
// length included, in global memory; the pool is grouped by node over the
// whole mesh once a solve; per attempt every block's core over several
// CTAs, the exchange of the records, and one step launch that merges them,
// applies from nstar's lists and advances.  The journal lives with the walk
// on each process and records the replicated words and the node rows of
// that process's own blocks, so a discard restores every word the
// statement wrote, each on the process that holds it.
#include "victim_common.cuh"

// the popped job's statement ends (thread 0): discard unless the gang
// pipelined; the job stays available only when it pipelined and placed
// something
static __device__ __forceinline__ void vtt_finish_job(const VttVictimArgs& a, VttWalk& w) {
  const int j = w.cur;
  const bool pip = !a.gang_pipelined || a.job_occupied[j] + a.pipe[j] >= a.job_min[j];
  if (!pip) {
    vtt_jrestore(a, w.jr);
    a.ctl[VC_ATT] = w.ck_att;
  }
  a.job_avail[j] = (pip && w.assigned) ? 1 : 0;
  w.phase = 0;
  w.jr.on = false;
  w.jr.len = 0;
}

static __device__ __forceinline__ void vtt_pw_init(VttWalk& w) {
  w.phase = w.qpos = w.cur = w.j2pos = w.iters = 0;
  w.assigned = w.last_v = w.any_p1 = w.att_total = w.ck_att = 0;
  w.jr = VttJournal{false, 0};
}

// Advance the state machine to its next attempt (all threads): true with
// w.at set, false when the walk ended.
static __device__ __forceinline__ bool vtt_pw_advance(const VttVictimArgs& a, VttWalk& w,
                                                      VttVJobKey* s_key,
                                                      VttWalkTm* tm = nullptr) {
  const int tid = threadIdx.x;
  const int J = (int)a.J, Q = (int)a.Q, T = (int)a.T;
  const int nu = (int)a.nu, nq = (int)a.nq;
  const long long cap = 4LL * T + 4LL * J + (long long)nq * (nu + 4) + 64;
  for (;;) {
    if (tid == 0) w.go = !a.ctl[VC_ABORT] && w.qpos < nq && w.iters < cap;
    __syncthreads();
    // every thread reads go and phase before thread 0 moves them
    const bool go = w.go;
    const int phase = w.phase;
    __syncthreads();
    if (!go) return false;
    if (phase == 2) {
      // Phase 2 takes one attemptless step for each task that is not to
      // be attempted (cursor + 1) and for each exhausted job (j2pos + 1):
      // most under-request jobs have no task left or only tasks another
      // pass takes.  Take such steps together, each run found over the
      // whole CTA, as many as the iteration cap allows, counted as taken;
      // then re-check the walk's go.
      int* s_first = reinterpret_cast<int*>(s_key);
      // the first i in [lo, hi) with pred(i), or hi (all threads)
      auto find_first = [&](int lo, int hi, auto pred) -> int {
        if (tid == 0) *s_first = hi;
        __syncthreads();
        for (int base = lo; base < hi; base += blockDim.x) {
          const int i = base + tid;
          if (i < hi && pred(i)) atomicMin(s_first, i);
          __syncthreads();
          if (*s_first < hi) break;
        }
        const int first = *s_first;
        __syncthreads();
        return first;
      };
      bool moved = false;
      for (;;) {
        const int j0 = w.j2pos;
        const long long left = cap - (long long)w.iters;
        if (j0 >= nu || left <= 0) break;
        const int j = a.under_request[vtt_clamp(j0, 0, J - 1)];
        const int c0 = a.cursor[j], n = a.job_ntasks[j];
        if (c0 < n) {
          const int start = a.job_start[j];
          const int c = find_first(c0, (int)min((long long)n, c0 + left), [&](int k) {
            return a.task_attempt[vtt_clamp(start + k, 0, T - 1)] != 0;
          });
          if (c == c0) break;
          if (tid == 0) {
            a.cursor[j] = c;
            w.iters += c - c0;
          }
          __syncthreads();
          moved = true;
          if (c < n) break;
          continue;
        }
        const int first = find_first(j0, (int)min((long long)nu, j0 + left), [&](int i) {
          const int jj = a.under_request[vtt_clamp(i, 0, J - 1)];
          return a.cursor[jj] < a.job_ntasks[jj];
        });
        if (tid == 0) {
          w.j2pos = first;
          w.iters += first - j0;
        }
        __syncthreads();
        moved = true;
      }
      if (moved) continue;
    }
    if (phase == 0) {
      const int q = a.queues_order[vtt_clamp(w.qpos, 0, Q - 1)];
      const int j = vtt_select_job(a, q, s_key, tm);
      if (tid == 0) {
        w.do_att = 0;
        if (j >= 0) {
          w.cur = j;
          w.assigned = 0;
          a.job_avail[j] = 0;
          // the statement's checkpoint
          w.jr.on = true;
          w.jr.len = 0;
          w.ck_att = a.ctl[VC_ATT];
          w.phase = 1;
        } else {
          w.phase = 2;
          w.j2pos = 0;
        }
      }
    } else if (tid == 0) {
      if (phase == 1) {
        const int j = w.cur;
        const bool exhausted = a.cursor[j] >= a.job_ntasks[j];
        const int t = vtt_clamp(a.job_start[j] + a.cursor[j], 0, T - 1);
        w.do_att = !exhausted && a.task_attempt[t];
        w.t = t;
        w.jt = j;
        w.qm = 1;
        if (!exhausted)
          a.cursor[j] += 1;
        else
          vtt_finish_job(a, w);
      } else {
        const bool done = w.j2pos >= nu;
        const int j = a.under_request[vtt_clamp(w.j2pos, 0, J - 1)];
        const bool exhausted = a.cursor[j] >= a.job_ntasks[j];
        const int t = vtt_clamp(a.job_start[j] + a.cursor[j], 0, T - 1);
        w.do_att = !done && !exhausted && a.task_attempt[t];
        w.t = t;
        w.jt = j;
        w.qm = 0;
        if (done) {
          w.qpos += 1;
          w.phase = 0;
        } else if (exhausted) {
          w.j2pos += 1;
        } else {
          a.cursor[j] += 1;
        }
      }
    }
    __syncthreads();
    if (w.do_att) {
      if (tid == 0) vtt_attempt_init(a, w.at, w.t, w.jt, w.qm ? 0 : 1);
      __syncthreads();
      return true;
    }
    if (tid == 0) w.iters += 1;
  }
}

// After the attempt (thread 0; an ok attempt is applied already, with nv
// victims).
static __device__ __forceinline__ void vtt_pw_after(const VttVictimArgs& a, VttWalk& w,
                                                    int nstar, bool clean, int nv) {
  if (!clean) a.ctl[VC_ABORT] = 1;
  if (nstar >= 0 && clean) {
    w.att_total += 1;
    if (w.qm) {
      w.assigned = 1;
      w.last_v = nv;
      w.any_p1 = 1;
    }
  }
  // phase 2 stops a job's drain at its first failed attempt
  if (!w.qm && clean && nstar < 0) w.j2pos += 1;
  // phase 1 checks JobPipelined after every attempt, ok or not
  const int jt = w.jt;
  if (w.qm && clean && (!a.gang_pipelined || a.job_occupied[jt] + a.pipe[jt] >= a.job_min[jt]))
    vtt_finish_job(a, w);
  w.iters += 1;
}

static __device__ __forceinline__ void vtt_pw_final(const VttVictimArgs& a,
                                                    const VttWalk& w) {
  a.ctl[VC_ATT_TOTAL] = w.att_total;
  a.ctl[VC_LAST_V] = w.last_v;
  a.ctl[VC_ANY] = w.any_p1;
  a.ctl[VC_ITERS] = w.iters;
  if (w.qpos < a.nq) a.ctl[VC_ABORT] = 1;
}

// the walk's state machine, as vtt_walk_cluster takes it
struct VttPreemptWalk {
  static __device__ void init(VttWalk& w) { vtt_pw_init(w); }
  static __device__ bool advance(const VttVictimArgs& a, VttWalk& w, VttVJobKey* s_key,
                                 VttWalkTm* tm) {
    return vtt_pw_advance(a, w, s_key, tm);
  }
  static __device__ void after(const VttVictimArgs& a, VttWalk& w, int nstar, bool clean) {
    const int nv = (nstar >= 0 && clean) ? vtt_apply(a, w.at, nstar, w.jr) : 0;
    vtt_pw_after(a, w, nstar, clean, nv);
  }
  static __device__ void finish(const VttVictimArgs& a, const VttWalk& w) { vtt_pw_final(a, w); }
};

// one CTA an SM (minBlocks 1): without it ptxas caps the kernel at 32
// registers and spills in the node walk.  TM: the timed instantiation.
template <bool TM>
__global__ void __launch_bounds__(VTT_VICTIM_THREADS, 1)
    vtt_preempt_kernel(VttVictimArgs a) {
  vtt_walk_cluster<VttPreemptWalk, TM>(a);
}

extern "C" int vtt_preempt_solve(const VttVictimArgs* args, void* stream) {
  const VttVictimArgs a = *args;
  if (a.R < 2 || a.R > VTT_MAX_R || a.n_keys > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_group_launch(a, VTT_EV_PREEMPT, s);
  if (err) return err;
  return vtt_walk_launch(a.x_split ? vtt_preempt_kernel<true> : vtt_preempt_kernel<false>, a, s);
}

// ---- K15b: the walk on node blocks ---------------------------------------

// start (!step): the walk's state, then its first attempt; step: the
// pending attempt from the exchanged records, then the next one.  The
// pending flag lands in ctl[VC_WALK].
__global__ void __launch_bounds__(VTT_VICTIM_THREADS)
    vtt_preempt_blocks_kernel(VttVictimArgs a, const VttVictimArgs* blocks, int L, int step) {
  __shared__ VttVJobKey s_key[VTT_VICTIM_THREADS];
  VttWalk& w = *(VttWalk*)a.walk;
  if (threadIdx.x == 0) {
    if (step) {
      int nstar, nv;
      bool clean;
      vtt_wb_apply(a, blocks, L, w, nstar, clean, nv);
      vtt_pw_after(a, w, nstar, clean, nv);
    } else {
      vtt_pw_init(w);
    }
  }
  __syncthreads();
  const bool more = vtt_pw_advance(a, w, s_key);
  if (threadIdx.x == 0) {
    a.ctl[VC_WALK] = more ? 1 : 0;
    if (!more) vtt_pw_final(a, w);
  }
}

// Begin a K15b solve, as vtt_reclaim_blocks_begin does for K15a.
extern "C" int vtt_preempt_blocks_begin(const VttVictimArgs* base, const VttVictimArgs* dblk,
                                        int n_blocks, int* pending, void* stream) {
  const VttVictimArgs& a = *base;
  if (!vtt_walk_ok(a) || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_group_launch(a, VTT_EV_PREEMPT, s);
  if (err) return err;
  VTT_LAUNCH(vtt_preempt_blocks_kernel, 1, VTT_VICTIM_THREADS, 0, s)(a, dblk, n_blocks, 0);
  return vtt_walk_pending(a, pending, s);
}

// One attempt's step, after the exchange filled base->recv.
extern "C" int vtt_preempt_blocks_step(const VttVictimArgs* base, const VttVictimArgs* dblk,
                                       int n_blocks, int* pending, void* stream) {
  const VttVictimArgs& a = *base;
  cudaStream_t s = (cudaStream_t)stream;
  VTT_LAUNCH(vtt_preempt_blocks_kernel, 1, VTT_VICTIM_THREADS, 0, s)(a, dblk, n_blocks, 1);
  return vtt_walk_pending(a, pending, s);
}
