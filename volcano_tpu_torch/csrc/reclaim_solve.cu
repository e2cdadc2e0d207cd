// K8: the whole reclaim action as ONE launch of one thread-block cluster;
// K15a: the same walk with the node planes in blocks.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:457 `reclaim_solve`
// (reclaim.go:42-201): pop the queue with the lowest proportion share, pop
// its best job once, attempt that job's head task against the running
// tasks of every other queue, and re-arm the queue only on success.
//
// What bounds it on the H100: latency.  Every attempt depends on the state
// the one before it left, so the action is a chain of at most 2 (J + Q) + 64
// steps; a step walks every node's pool rows three times through dependent
// loads and scores the valid nodes.  Design: the setup kernels group the
// pool by node once a solve (victim_common.cuh); then vtt_walk_cluster runs
// the loop on one cluster of up to 16 CTAs x 1024 threads, one node a
// thread over row-balanced node ranges, with the queue and job choice and
// the state update on rank 0.  An attempt that is not clean (the
// reference's walk would strand evictions) stops the loop with the abort
// flag set, as the JAX loop does.
//
// K15a replaces the same function under a mesh with solveMode: batch
// (volcano_tpu/scheduler/fast_victims.py:148-163: the node planes of the
// constants and state split into S blocks of rows, the [V] pool, job and
// queue state replicated).  The walk is the same device code
// (vtt_rw_advance / vtt_rw_after) with its state in global memory, and
// every attempt leaves the CTA: vtt_reclaim_blocks_begin groups the
// replicated pool by node over the whole mesh once a solve and advances the
// walk to its first attempt; per attempt the host launches the blocks'
// cores (vtt_walk_blocks_core, victim_step.cu: several CTAs a block, one
// node a thread), exchanges the S records (K12b's: the lexicographic minima
// of the block's covered and valid nodes) and launches
// vtt_reclaim_blocks_step, which merges them, reruns the flag pass of the
// chosen node's rows from its lists, applies (node rows on the owner block
// only) and advances to the next attempt.  One host read of a 4-byte flag
// per attempt; an abort stops every process at the same attempt, since the
// walk and the records are replicated.
#include "victim_common.cuh"

// Advance the walk to its next attempt (all threads): true with w.at set,
// false when the walk ended.
static __device__ __forceinline__ bool vtt_rw_advance(const VttVictimArgs& a, VttWalk& w,
                                                      VttVJobKey* s_key,
                                                      VttWalkTm* tm = nullptr) {
  const int tid = threadIdx.x;
  const int J = (int)a.J, Q = (int)a.Q, T = (int)a.T, R = (int)a.R;
  const int cap = 2 * (J + Q) + 64;
  for (;;) {
    if (tid == 0) {
      bool any_q = false;
      for (int q = 0; q < Q; ++q) any_q = any_q || a.queue_live[q];
      w.go = !a.ctl[VC_ABORT] && any_q && w.iters < cap;
      if (w.go) {
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
        w.qstar = qstar;
        w.over = a.has_proportion &&
                 vtt_less_equal(&a.queue_deserved[(size_t)qstar * R],
                                &a.queue_alloc[(size_t)qstar * R], a.eps, R);
      }
    }
    __syncthreads();
    if (!w.go) return false;
    const int qstar = w.qstar;
    const int j = w.over ? -1 : vtt_select_job(a, qstar, s_key, tm);
    if (j < 0) {
      // nothing to take from this queue: it leaves the priority queue
      if (tid == 0) {
        a.queue_live[qstar] = 0;
        w.iters += 1;
      }
      __syncthreads();
      continue;
    }
    if (tid == 0) {
      w.job = j;
      vtt_attempt_init(a, w.at, vtt_clamp(a.job_start[j], 0, T - 1), j, 2);
    }
    __syncthreads();
    return true;
  }
}

// After the attempt (thread 0; an ok attempt is applied already): the job
// is popped, its queue re-armed only on success, an unclean walk aborts.
static __device__ __forceinline__ void vtt_rw_after(const VttVictimArgs& a, VttWalk& w,
                                                    int nstar, bool clean) {
  a.job_avail[w.job] = 0;
  a.queue_live[w.qstar] = (nstar >= 0 && clean) ? 1 : 0;
  if (!clean) a.ctl[VC_ABORT] = 1;
  w.iters += 1;
}

static __device__ __forceinline__ void vtt_rw_final(const VttVictimArgs& a, const VttWalk& w) {
  a.ctl[VC_ITERS] = w.iters;
  if (w.iters >= 2 * (a.J + a.Q) + 64) a.ctl[VC_ABORT] = 1;
}

// the walk's state machine, as vtt_walk_cluster takes it
struct VttReclaimWalk {
  static __device__ void init(VttWalk& w) {
    w.iters = 0;
    w.jr = VttJournal{false, 0};
  }
  static __device__ bool advance(const VttVictimArgs& a, VttWalk& w, VttVJobKey* s_key,
                                 VttWalkTm* tm) {
    return vtt_rw_advance(a, w, s_key, tm);
  }
  static __device__ void after(const VttVictimArgs& a, VttWalk& w, int nstar, bool clean) {
    if (nstar >= 0 && clean) vtt_apply(a, w.at, nstar, w.jr);
    vtt_rw_after(a, w, nstar, clean);
  }
  static __device__ void finish(const VttVictimArgs& a, const VttWalk& w) { vtt_rw_final(a, w); }
};

// one CTA an SM (minBlocks 1): without it ptxas caps the kernel at 32
// registers and spills in the node walk.  TM: the timed instantiation.
template <bool TM>
__global__ void __launch_bounds__(VTT_VICTIM_THREADS, 1)
    vtt_reclaim_kernel(VttVictimArgs a) {
  vtt_walk_cluster<VttReclaimWalk, TM>(a);
}

extern "C" int vtt_reclaim_solve(const VttVictimArgs* args, void* stream) {
  const VttVictimArgs a = *args;
  if (a.R < 2 || a.R > VTT_MAX_R || a.n_keys > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_group_launch(a, VTT_EV_RECLAIM, s);
  if (err) return err;
  return vtt_walk_launch(a.x_split ? vtt_reclaim_kernel<true> : vtt_reclaim_kernel<false>, a, s);
}

// ---- K15a: the walk on node blocks ---------------------------------------

// start (!step): the walk's state, then its first attempt; step: the
// pending attempt from the exchanged records, then the next one.  The
// pending flag lands in ctl[VC_WALK].
__global__ void __launch_bounds__(VTT_VICTIM_THREADS)
    vtt_reclaim_blocks_kernel(VttVictimArgs a, const VttVictimArgs* blocks, int L, int step) {
  __shared__ VttVJobKey s_key[VTT_VICTIM_THREADS];
  VttWalk& w = *(VttWalk*)a.walk;
  if (threadIdx.x == 0) {
    if (step) {
      int nstar, nv;
      bool clean;
      vtt_wb_apply(a, blocks, L, w, nstar, clean, nv);
      vtt_rw_after(a, w, nstar, clean);
    } else {
      VttReclaimWalk::init(w);
    }
  }
  __syncthreads();
  const bool more = vtt_rw_advance(a, w, s_key);
  if (threadIdx.x == 0) {
    a.ctl[VC_WALK] = more ? 1 : 0;
    if (!more) vtt_rw_final(a, w);
  }
}

// Begin a K15a solve: the replicated pool grouped by node over the mesh's
// N rows (the base's node_off and lists, which every block's core slices),
// the walk to its first attempt; *pending says whether one waits (the host
// then runs vtt_walk_blocks_core, the exchange and vtt_reclaim_blocks_step
// until it is 0).  `dblk`: the local blocks in device memory.
extern "C" int vtt_reclaim_blocks_begin(const VttVictimArgs* base, const VttVictimArgs* dblk,
                                        int n_blocks, int* pending, void* stream) {
  const VttVictimArgs& a = *base;
  if (!vtt_walk_ok(a) || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_group_launch(a, VTT_EV_RECLAIM, s);
  if (err) return err;
  VTT_LAUNCH(vtt_reclaim_blocks_kernel, 1, VTT_VICTIM_THREADS, 0, s)(a, dblk, n_blocks, 0);
  return vtt_walk_pending(a, pending, s);
}

// One attempt's step, after the exchange filled base->recv.
extern "C" int vtt_reclaim_blocks_step(const VttVictimArgs* base, const VttVictimArgs* dblk,
                                       int n_blocks, int* pending, void* stream) {
  const VttVictimArgs& a = *base;
  cudaStream_t s = (cudaStream_t)stream;
  VTT_LAUNCH(vtt_reclaim_blocks_kernel, 1, VTT_VICTIM_THREADS, 0, s)(a, dblk, n_blocks, 1);
  return vtt_walk_pending(a, pending, s);
}
