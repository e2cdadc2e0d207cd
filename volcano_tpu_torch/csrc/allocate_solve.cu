// K2: the exact sequential allocate solve as ONE persistent CTA.
//
// Replaces volcano_tpu/scheduler/kernels.py:185 `allocate_solve` (with
// portsel=None, volsel=None) — a jitted lax.while_loop whose body is either
// a select step (queue by proportion share, overuse drop, job by the
// lexicographic tier key) or a place step (head-task fit, predicates,
// score, first-max argmax, state update).
//
// What bounds it on the H100: latency, not bytes or operations.  Each step
// depends on the one before it, so the solve is a chain of ~T + J steps of
// O(N + J) work; a step reads its node state (about 40 bytes a node) from
// L2, where the whole state fits (N = 16384 -> well under 1 MB).  Design:
// one 1024-thread CTA runs the whole loop — one launch per solve, never one
// per step — with block-wide reductions between __syncthreads; thread 0
// applies each step's scalar update.  The state lives in global memory in
// the wrapper's working copies and stays L2-resident, the select step's
// per-queue flags too (`queue_has`, sized by Q, so any queue count runs).
//
// K5 in K2 (has_portsel): replaces the portsel branches of the same
// function, kernels.py:308-322 (port, required- and anti-selector
// feasibility), :356-361 (the interpod score term) and :398-405 (the placed
// pod's ports and labels join its node).  The inputs stay packed u32 words
// (tensor_actions.py:664-684 unpacked them on the device; here no unpack
// runs at all): each node's test is four port-word ANDs and two ANDs
// against a per-node "selector matched" word pair, kept beside the counts
// and refreshed where a count moves; the score reads only the counts of the
// task's own selector bits.  Bound: the same chain of dependent steps as
// K2 itself; K5 adds 24 bytes a node to a step's L2 reads (16 of ports, 8
// of match words) and touches the counts of the placed node only.  The
// kernel is a template on the flag: without portsel the K5 code is not
// compiled in at all, so the plain solve keeps its registers and speed.
//
// K6 in K2 (has_volsel): replaces the volsel branches of the same function,
// kernels.py:323-342 (the task's feasible-node bitset, and per claim the
// assumed node or the group's remaining capacity), :406-423 (the first
// idle-fit placement of each claim assumes a volume there and takes one PV
// off its group's count: the whole row for a global pool, the taken node's
// column for a pinned one; a pipelined placement assumes nothing) and the
// initial state at :455-462.  The inputs stay packed: a task's mask row is
// tested in place, one bit a node (a warp's 32 nodes share one word), and
// its claims (at most 64, two u32 words) are listed once a step by thread 0
// in shared memory with their group, pool kind and assumed node.  The claim
// and capacity state are working copies in global memory (vol_cap is
// G x N x 4 bytes, about 160 KB at G = 4, N = 10,240: L2-resident).  Bound:
// the same chain of dependent steps as K2; K6 adds to a step the task's
// mask row (N / 8 bytes) and one capacity read a node per unassumed claim,
// and to a placement one decrement per claim, or a row of N for a claim of
// a global pool.  A second template flag: solves without volumes compile
// none of it.
#include "common.cuh"

#define VTT_EXACT_THREADS 1024

// lexicographic job key of the select step (job_key_order, then index)
struct VttJobKey {
  float k[4];
  int j;
};

__device__ __forceinline__ bool vtt_key_less(const VttJobKey& a,
                                             const VttJobKey& b, int nk) {
  for (int i = 0; i < nk; ++i) {
    if (a.k[i] < b.k[i]) return true;
    if (a.k[i] > b.k[i]) return false;
  }
  return a.j < b.j;
}

__device__ __forceinline__ float vtt_job_key(const VttSolveArgs& a, int code,
                                             int j, const int32_t* ready) {
  if (code == VTT_KEY_PRIORITY) return -(float)a.job_prio[j];
  if (code == VTT_KEY_GANG) return ready[j] >= a.job_min[j] ? 1.0f : 0.0f;
  return vtt_dominant_share(&a.job_alloc[(size_t)j * a.R], a.total, (int)a.R);
}

__device__ __forceinline__ bool vtt_exact_active(const VttSolveArgs& a, int j) {
  const int q = a.job_queue[j];
  const int qc = q < 0 ? 0 : (q >= (int)a.Q ? (int)a.Q - 1 : q);
  return a.job_schedulable[j] && !a.dropped[j] && a.cursor[j] < a.job_ntasks[j] &&
         !a.queue_dropped[qc] && q >= 0;
}

template <bool PS, bool VS>
__global__ void __launch_bounds__(VTT_EXACT_THREADS)
    vtt_allocate_solve_kernel(VttSolveArgs a) {
  __shared__ VttVsTask s_vs;
  __shared__ float s_v[VTT_EXACT_THREADS];
  __shared__ int s_i[VTT_EXACT_THREADS];
  __shared__ VttJobKey s_key[VTT_EXACT_THREADS];
  __shared__ int s_flag;
  __shared__ int s_cur;
  __shared__ int s_qstar;
  // which queues hold an active job: global scratch sized by Q
  uint8_t* s_qhas = a.queue_has;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int N = (int)a.N, R = (int)a.R, T = (int)a.T, J = (int)a.J,
            Q = (int)a.Q;
  int32_t* task_node = a.packed;
  int32_t* task_kind = a.packed + T;
  int32_t* task_seq = a.packed + 2 * T;
  int32_t* ready = a.packed + 3 * T;
  const int codes[3] = {(int)a.key0, (int)a.key1, (int)a.key2};
  const int nk = (int)a.n_keys;
  int counter = 0;
  if (PS)
    for (int n = tid; n < N; n += nthr) vtt_ps_init_node(a, n);
  if (tid == 0) s_cur = -1;
  __syncthreads();

  for (;;) {
    const int cur = s_cur;
    if (cur < 0) {
      // ---- select step
      for (int q = tid; q < Q; q += nthr) s_qhas[q] = 0;
      __syncthreads();
      bool any_local = false;
      for (int j = tid; j < J; j += nthr) {
        if (vtt_exact_active(a, j)) {
          const int q = a.job_queue[j];
          s_qhas[q >= Q ? Q - 1 : q] = 1;
          any_local = true;
        }
      }
      if (!vtt_block_any(any_local, &s_flag)) break;
      if (tid == 0) {
        int qstar = -1;
        float best = VTT_POS_INF;
        for (int q = 0; q < Q; ++q) {
          if (!s_qhas[q]) continue;
          const float share =
              a.use_proportion
                  ? vtt_dominant_share(&a.queue_alloc[(size_t)q * R],
                                       &a.queue_deserved[(size_t)q * R], R)
                  : 0.0f;
          if (qstar < 0 || share < best) {
            best = share;
            qstar = q;
          }
        }
        if (a.use_proportion &&
            vtt_less_equal(&a.queue_deserved[(size_t)qstar * R],
                           &a.queue_alloc[(size_t)qstar * R], a.eps, R)) {
          a.queue_dropped[qstar] = 1;
          s_qstar = -1;
        } else {
          s_qstar = qstar;
        }
      }
      __syncthreads();
      const int qstar = s_qstar;
      if (qstar < 0) continue;
      VttJobKey best;
      best.j = -1;
      for (int j = tid; j < J; j += nthr) {
        if (!vtt_exact_active(a, j) || a.job_queue[j] != qstar) continue;
        VttJobKey kj;
        for (int i = 0; i < nk; ++i) kj.k[i] = vtt_job_key(a, codes[i], j, ready);
        kj.j = j;
        if (best.j < 0 || vtt_key_less(kj, best, nk)) best = kj;
      }
      s_key[tid] = best;
      __syncthreads();
      for (int s = nthr / 2; s > 0; s >>= 1) {
        if (tid < s) {
          const VttJobKey& o = s_key[tid + s];
          if (o.j >= 0 && (s_key[tid].j < 0 || vtt_key_less(o, s_key[tid], nk)))
            s_key[tid] = o;
        }
        __syncthreads();
      }
      if (tid == 0) s_cur = s_key[0].j;
      __syncthreads();
      continue;
    }

    // ---- place step: head task of the current job
    const int j = cur;
    const int t = a.job_start[j] + a.cursor[j];
    float req[VTT_MAX_R];
    for (int r = 0; r < R; ++r) req[r] = a.task_req[(size_t)t * R + r];
    const int cls = a.task_class[t];
    const uint8_t* cmask = a.class_mask + (size_t)cls * N;
    const float* cscore = a.class_score + (size_t)cls * N;
    VttPs ps{};
    if (PS) ps = vtt_ps_task(a, t);
    if (VS) {
      if (tid == 0) vtt_vs_task(a, t, s_vs);
      __syncthreads();
    }
    float bv = VTT_NEG_INF;
    int bi = 0x7fffffff;
    for (int n = tid; n < N; n += nthr) {
      if (!a.node_valid[n] || !cmask[n] || a.task_count[n] >= a.node_max_tasks[n])
        continue;
      const bool fit_i = vtt_less_equal(req, &a.idle[(size_t)n * R], a.eps, R);
      const bool fit_r = vtt_less_equal(req, &a.releasing[(size_t)n * R], a.eps, R);
      if (!fit_i && !fit_r) continue;
      if (PS && !vtt_ps_feasible(a, n, ps)) continue;
      if (VS && !vtt_vs_feasible(a, n, t, s_vs)) continue;
      float sc = vtt_score_node(req, &a.used[(size_t)n * R],
                                &a.node_alloc[(size_t)n * R], cscore[n],
                                a.w_least, a.w_balanced);
      if (PS) sc = vtt_ps_score(a, n, ps, sc);
      if (vtt_better(sc, n, bv, bi)) {
        bv = sc;
        bi = n;
      }
    }
    vtt_block_argmax(bv, bi, s_v, s_i);
    if (tid == 0) {
      if (bi == 0x7fffffff) {
        // head task unschedulable -> job dropped this cycle
        a.dropped[j] = 1;
        s_cur = -1;
      } else {
        const int n = bi;
        float* nid = &a.idle[(size_t)n * R];
        float* nrel = &a.releasing[(size_t)n * R];
        const bool use_idle = vtt_less_equal(req, nid, a.eps, R);
        for (int r = 0; r < R; ++r) {
          if (use_idle)
            nid[r] = nid[r] - req[r];
          else
            nrel[r] = nrel[r] - req[r];
          a.used[(size_t)n * R + r] = a.used[(size_t)n * R + r] + req[r];
          a.job_alloc[(size_t)j * R + r] = a.job_alloc[(size_t)j * R + r] + req[r];
        }
        a.task_count[n] += 1;
        const int new_ready = ready[j] + (use_idle ? 1 : 0);
        ready[j] = new_ready;
        const bool now_ready = a.use_gang_ready ? new_ready >= a.job_min[j] : true;
        const bool exhausted = a.cursor[j] + 1 >= a.job_ntasks[j];
        a.cursor[j] += 1;
        const int q = a.job_queue[j];
        for (int r = 0; r < R; ++r)
          a.queue_alloc[(size_t)q * R + r] = a.queue_alloc[(size_t)q * R + r] + req[r];
        task_node[t] = n;
        task_kind[t] = use_idle ? 1 : 2;
        task_seq[t] = counter;
        s_cur = (now_ready || exhausted) ? -1 : j;
        // the placed pod is resident now, pipelined or not
        if (PS) vtt_ps_fold(a, n, ps, +1);
        // its claims assume their volumes here, on an idle fit only
        if (VS && use_idle) vtt_vs_assume(a, n, s_vs);
      }
    }
    counter += (bi != 0x7fffffff) ? 1 : 0;
    __syncthreads();
    if (VS && s_vs.any_global_fresh) {
      vtt_vs_fold_global(a, s_vs);
      __syncthreads();
    }
  }
  if (tid == 0) a.ctl[0] = counter;
}

template <bool PS, bool VS>
static void vtt_exact_launch(const VttSolveArgs& a, cudaStream_t s) {
  void (*kernel)(VttSolveArgs) = vtt_allocate_solve_kernel<PS, VS>;
  VTT_LAUNCH(kernel, 1, VTT_EXACT_THREADS, 0, s)(a);
}

extern "C" int vtt_allocate_solve(const VttSolveArgs* args, void* stream) {
  const VttSolveArgs& a = *args;
  if (a.R < 2 || a.R > VTT_MAX_R || a.Q < 1 || !a.queue_has || a.n_keys > 3 ||
      (a.has_volsel && (a.CL < 1 || a.CL > VTT_CLAIMS || a.VW * 32 < a.N)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.has_portsel && a.has_volsel)
    vtt_exact_launch<true, true>(a, s);
  else if (a.has_volsel)
    vtt_exact_launch<false, true>(a, s);
  else if (a.has_portsel)
    vtt_exact_launch<true, false>(a, s);
  else
    vtt_exact_launch<false, false>(a, s);
  return (int)cudaGetLastError();
}
