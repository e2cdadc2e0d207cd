// K3: the batched-rounds allocate solve on node blocks; K12a runs it over
// S blocks.
//
// Replaces volcano_tpu/scheduler/kernels.py:491 `allocate_solve_batch`
// (portsel=None, exact_topk=True) and, with S > 1 blocks,
// volcano_tpu/parallel/sharded.py:152 `_cycle` / :230 `make_sharded_cycle`
// (the same solve with every node-shaped plane split into equal blocks of
// rows).  Each round: rank the jobs by the tier key, let the top M propose
// their next P tasks over their K best nodes, accept the (node, rank)-
// ordered proposals whose running request sum fits the node, apply the
// winners, and drop (with gang rollback) the lowest-ranked job when
// nothing won.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): per round,
// the [M, N] head-task score pass (M = 512 jobs x N nodes, ~40 bytes and
// ~30 flops a cell, from L2); far below the card's rates, so the round is
// bound by its launches and its serial chains, and the solve by its round
// count.  Design:
//   * the host runs the round loop (scheduler/kernels.py batch_launch) and
//     reads ONE 4-byte flag a round: the active-job count, which
//     vtt_batch_keys accumulates only when the last round progressed (the
//     reference's `progressed & any(active)`);
//   * the select is a top-M by chunks (common.cuh vtt_sel_*, shared with
//     K10's rounds), O(J log^2 C) a round in place of a count over all
//     pairs of jobs: vtt_batch_chunk (one CTA per chunk of
//     VTT_SEL_CHUNK jobs) sorts the chunk's active jobs in shared memory
//     by a bitonic network and keeps its M first; vtt_batch_merge gives
//     each kept job its rank among every chunk's kept jobs (a binary search
//     a chunk); vtt_batch_place writes sel[rank] for rank < M and the
//     largest active job (the drop victim, ctl[3]) from the chunks' last
//     ones.  The M first jobs of the whole order all lie in their chunks'
//     M first, so the ranks are exact.  Every comparison is vtt_rank_less
//     on the float keys and jidx: no packed integer key, so -0.0 and +0.0
//     (the priority key of priority 0) compare equal as the reference's
//     sort has them, and the order is the old count's wherever that count
//     was a permutation -- that is, wherever no key is NaN (a share is
//     alloc / denom of finite quantities, or 0 / 1 for a zero denom);
//   * node blocks (VttSolveArgs n0 / NB; one block is the whole of K3):
//     vtt_batch_tiles runs one CTA per (selected job, tile of TILE rows of
//     the block), the tile's scores in shared memory, and writes the tile's
//     exact top-K (value, global row); vtt_batch_pack merges a job's tiles
//     into the block's top-K and writes one record per candidate: value,
//     row, feasible and idle-fit bits, task count, pod cap, idle and
//     releasing -- everything the decision reads of a node.  Tiles lift
//     the shared-memory cap on N; the union of the parts' top-Ks holds the
//     global top-K, so the decisions do not change;
//   * the exchange (the host: nothing on one device, an all-gather over a
//     process group) gives every block every block's records;
//   * vtt_batch_propose (one CTA per selected job) merges the S x K records
//     into the job's top-K in lax.top_k's order (values descending, lower
//     index first), then rotates by rank, counts tasks per target and
//     writes the P proposals.  The accept is five launches, each as wide as
//     its work: vtt_batch_sort (one CTA) orders the F = M*P proposals by
//     (node, flat index) with a stable radix sort on the node, 4 bits a
//     pass, of the proposals in flat order; vtt_batch_seg (one thread per
//     node segment, over the card) keeps the running request sum against
//     the record's idle + eps and pod cap, and K5's running port and label
//     words; vtt_batch_jobs (one thread per selected job) takes the pipe
//     wins, cancels past the first loss of each job's offsets and updates
//     job_alloc (in offset order), ready, cursor and the task rows;
//     vtt_batch_queue (one CTA) compacts the winners in flat order with a
//     block scan and lets one thread per (queue, resource) add its queue's
//     winners in that order -- the queue sums outgrow float32's exact range
//     at scale, so no atomics and no tree -- then decides the no-win drop.
//     Every kernel is replicated: every block reaches the same winners from
//     the same records (integer atomicMin picks the best pipeline rank per
//     node);
//   * vtt_batch_apply_idle (a thread per node segment) and
//     vtt_batch_apply_pipe (a thread per proposal) apply the winners to the
//     rows each block owns, idle runs before pipe wins as one CTA did them;
//     vtt_batch_rollback unwinds a dropped gang's rows (one thread, in task
//     order) and vtt_batch_finish its task rows and job state
//     (replicated).
//
// K5 in K3 (has_portsel): replaces the portsel branches of the same
// function: the [M, N] port / required / anti feasibility and the interpod
// score (kernels.py:611-635), the one-task-per-target spread of heads with
// ports or self-matching anti-affinity (:702-710), the segmented exclusive
// cumulative-OR conflict scan (:763-793), the pipe exclusion of proposals
// with ports or anti selectors (:805-811), the scatter-OR / scatter-add of
// winners' ports and labels (:862-881) and the rollback's scatter-AND and
// subtract (:935-943); the on-device unpack of tensor_actions.py:664-684
// has no launch here, the words are tested in place.  Design: the tile
// pass tests a head's words against each node's port words and a per-node
// "selector matched" word pair (kept beside the counts, refreshed wherever
// a count moves) -- no matrix products, no per-node shared arrays; the
// segment walk (vtt_batch_seg), which already visits each node's
// proposals in rank order, carries six running words (4 of
// ports, 2 of labels) and ORs in every proposal, accepted or not, as the
// reference's scan does; the apply kernel folds ports and counts into the
// rows a block owns.  Bound: as K3; K5 adds 24 bytes a (job, node) pair to
// the score pass's reads, and only for heads that carry ports or
// selectors.  The kernels are templates on the flag: without portsel no K5
// code is compiled in.
#include "common.cuh"

#define VTT_PROPOSE_THREADS 256
#define VTT_ONE_CTA_THREADS 1024  // the sort and the queue sums (one CTA)
#define VTT_WIDE_THREADS 256      // the kernels spread over the card
#define VTT_TILE_MAX 8192
#define VTT_QTILE 1024            // winners a queue-sum tile stages
#define VTT_MAX_P 32

// p_flags bits
#define PF_VALID 1
#define PF_IDLE 2
#define PF_PIPE 4
#define PF_ACCEPT 8
#define PF_WIN 16
#define PF_USE_IDLE 32

__device__ __forceinline__ int vtt_clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// node_match from node_selcnt, once per solve and block (K5)
__global__ void vtt_ps_init(VttSolveArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < a.NB) vtt_ps_init_node(a, n);
}

__global__ void vtt_batch_init(VttSolveArgs a) {
  a.ctl[0] = 0;  // rounds
  a.ctl[1] = 0;  // active jobs if the last round progressed, else 0
  a.ctl[2] = 1;  // progressed
  a.ctl[4] = -1; // the job whose gang the round's apply rolls back
}

// active mask + rank keys per job; resets the per-round scratch
__global__ void vtt_batch_keys(VttSolveArgs a) {
  const int J = (int)a.J, R = (int)a.R, Q = (int)a.Q;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < a.N + 1) a.best_pipe[idx] = (int)a.F;
  if (idx < a.M) a.sel[idx] = -1;
  if (idx >= J) return;
  const int j = idx;
  const int jq = a.job_queue[j];
  const int qc = vtt_clampi(jq, 0, Q - 1);
  bool q_ok = true;
  if (a.use_proportion)
    q_ok = !vtt_less_equal(&a.queue_deserved[(size_t)qc * R],
                           &a.queue_alloc[(size_t)qc * R], a.eps, R);
  const bool active = a.job_schedulable[j] && !a.dropped[j] &&
                      a.cursor[j] < a.job_ntasks[j] && jq >= 0 && q_ok;
  a.job_active[j] = active ? 1 : 0;
  const int32_t* ready = a.packed + 3 * a.T;
  float* keys = a.job_keys + (size_t)j * 4;
  int nk = 0;
  if (a.use_proportion)
    keys[nk++] = vtt_dominant_share(&a.queue_alloc[(size_t)qc * R],
                                    &a.queue_deserved[(size_t)qc * R], R);
  const int codes[3] = {(int)a.key0, (int)a.key1, (int)a.key2};
  for (int i = 0; i < a.n_keys; ++i) {
    const int c = codes[i];
    if (c == VTT_KEY_PRIORITY)
      keys[nk++] = -(float)a.job_prio[j];
    else if (c == VTT_KEY_GANG)
      keys[nk++] = ready[j] >= a.job_min[j] ? 1.0f : 0.0f;
    else
      keys[nk++] = vtt_dominant_share(&a.job_alloc[(size_t)j * R], a.total, R);
  }
  if (active && a.ctl[2]) atomicAdd(&a.ctl[1], 1);
}

__device__ __forceinline__ int vtt_rank_nk(const VttSolveArgs& a) {
  return (int)(a.n_keys + (a.use_proportion ? 1 : 0));
}

__device__ __forceinline__ VttSel vtt_batch_sel(const VttSolveArgs& a) {
  return VttSel{a.job_active, a.job_keys, a.sel, a.c_key, a.c_job, a.c_rank, a.c_cnt,
                a.c_max, (int)a.J, (int)a.M, vtt_rank_nk(a), (int)a.nC};
}

// The select (common.cuh vtt_sel_*), stage 1: each chunk's list and its
// last active job; with one chunk that job is the drop victim (ctl[3]).
__global__ void __launch_bounds__(VTT_SEL_THREADS) vtt_batch_chunk(VttSolveArgs a) {
  const int last = vtt_sel_chunk(vtt_batch_sel(a));
  if (threadIdx.x == 0 && a.nC == 1 && last >= 0) a.ctl[3] = last;
}

// The select, stage 2: each kept job's rank among every chunk's list.
__global__ void __launch_bounds__(VTT_WIDE_THREADS) vtt_batch_merge(VttSolveArgs a) {
  vtt_sel_merge(vtt_batch_sel(a));
}

// The select, stage 3: sel[rank] for the kept jobs of rank < M; thread 0
// takes the drop victim, the last of the chunks' last active jobs.
__global__ void __launch_bounds__(VTT_WIDE_THREADS) vtt_batch_place(VttSolveArgs a) {
  vtt_sel_place(vtt_batch_sel(a));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int nk = vtt_rank_nk(a);
    int v = -1;
    for (int c2 = 0; c2 < a.nC; ++c2) {
      const int j = a.c_max[c2];
      if (j >= 0 && (v < 0 || vtt_rank_less(&a.job_keys[(size_t)v * 4], v,
                                            &a.job_keys[(size_t)j * 4], j, nk)))
        v = j;
    }
    if (v >= 0) a.ctl[3] = v;
  }
}

// record words: value bits, global row, flags, task count, pod cap, then
// idle [R] and releasing [R] (W = 5 + 2R)
#define RW_VAL 0
#define RW_ROW 1
#define RW_FLAGS 2
#define RW_TC 3
#define RW_CAP 4
#define RW_IDLE 5
// record flags
#define RF_FEASIBLE 1
#define RF_FIT_IDLE 2
#define RF_BLOCK_ANY 4

// The selected job m's head task: its request, class and K5 words.
struct VttHead {
  int j, cursor, t, cls;
  float req[VTT_MAX_R];
};

__device__ __forceinline__ VttHead vtt_head(const VttSolveArgs& a, int m) {
  VttHead h;
  h.j = a.sel[m];
  if (h.j < 0) return h;
  h.cursor = a.cursor[h.j];
  h.t = vtt_clampi(a.job_start[h.j] + h.cursor, 0, (int)a.T - 1);
  for (int r = 0; r < a.R; ++r) h.req[r] = a.task_req[(size_t)h.t * a.R + r];
  h.cls = a.task_class[h.t];
  return h;
}

// Block-local row ln against the head: idle fit, releasing fit, feasible.
template <bool PS>
__device__ __forceinline__ bool vtt_node_feasible(const VttSolveArgs& a, int ln,
                                                  const VttHead& h, const VttPs& hps,
                                                  bool& fit_i) {
  const int R = (int)a.R;
  fit_i = vtt_less_equal(h.req, &a.idle[(size_t)ln * R], a.eps, R);
  const bool fit_r = vtt_less_equal(h.req, &a.releasing[(size_t)ln * R], a.eps, R);
  return (fit_i || fit_r) && a.class_mask[(size_t)h.cls * a.NB + ln] &&
         a.task_count[ln] < a.node_max_tasks[ln] && a.node_valid[ln] &&
         (!PS || vtt_ps_feasible(a, ln, hps));
}

// one CTA per (selected job, tile of the block's rows): the head task's
// scores over the tile in shared memory, the tile's exact top-K
template <bool PS>
__global__ void __launch_bounds__(VTT_PROPOSE_THREADS)
    vtt_batch_tiles(VttSolveArgs a) {
  VTT_DYN_SMEM(float, s_val);
  __shared__ float s_v[VTT_PROPOSE_THREADS];
  __shared__ int s_i[VTT_PROPOSE_THREADS];
  __shared__ int s_p[VTT_PROPOSE_THREADS];
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int m = blockIdx.x, tb = blockIdx.y;
  const VttHead h = vtt_head(a, m);
  if (h.j < 0) return;
  const int R = (int)a.R, K = (int)a.K, TB = (int)a.TB;
  const int lo = tb * (int)a.TILE;
  const int hi = min((int)a.NB, lo + (int)a.TILE);
  const int n0 = (int)a.n0;
  const float* cscore = a.class_score + (size_t)h.cls * a.NB;
  const uint32_t jh = (uint32_t)h.j * 2654435761u;
  const float jscale = (float)(1e-4 / 65535.0);
  VttPs hps{};
  if (PS) hps = vtt_ps_task(a, h.t);

  bool any_local = false;
  for (int ln = lo + tid; ln < hi; ln += blockDim.x) {
    bool fit_i;
    float v = VTT_NEG_INF;
    if (vtt_node_feasible<PS>(a, ln, h, hps, fit_i)) {
      float sc = vtt_score_node(h.req, &a.used[(size_t)ln * R],
                                &a.node_alloc[(size_t)ln * R], cscore[ln],
                                a.w_least, a.w_balanced);
      if (PS) sc = vtt_ps_score(a, ln, hps, sc);
      const uint32_t g = (uint32_t)(n0 + ln);
      uint32_t hh = (jh ^ (g * 40503u)) * 2246822519u;
      hh ^= hh >> 15;
      v = __fmaf_rn((float)(hh & 0xFFFFu), jscale, sc);
      any_local = true;
    }
    s_val[ln - lo] = v;
  }
  const bool any = vtt_block_any(any_local, &s_flag);
  const size_t at = ((size_t)m * TB + tb) * K;
  __shared__ int s_pos[VTT_MAX_P];
  const int base = n0 + lo;
  vtt_block_topk(
      [&](int c, float& v, int& i) {
        v = s_val[c];
        i = base + c;
      },
      hi - lo, K, s_v, s_i, s_p, a.t_val + at, a.t_idx + at, s_pos);
  if (tid == 0) a.t_any[(size_t)m * TB + tb] = any ? 1 : 0;
}

// one CTA per selected job: the block's top-K from its tiles' candidates,
// packed into records with the node state the decision reads
template <bool PS>
__global__ void __launch_bounds__(VTT_PROPOSE_THREADS)
    vtt_batch_pack(VttSolveArgs a) {
  __shared__ float s_v[VTT_PROPOSE_THREADS];
  __shared__ int s_i[VTT_PROPOSE_THREADS];
  __shared__ int s_p[VTT_PROPOSE_THREADS];
  __shared__ float s_kv[VTT_MAX_P];
  __shared__ int s_ki[VTT_MAX_P];
  __shared__ int s_kp[VTT_MAX_P];
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int m = blockIdx.x;
  const VttHead h = vtt_head(a, m);
  if (h.j < 0) return;
  const int R = (int)a.R, K = (int)a.K, TB = (int)a.TB, W = (int)a.W;
  const float* tv = a.t_val + (size_t)m * TB * K;
  const int* ti = a.t_idx + (size_t)m * TB * K;
  bool any_local = false;
  for (int tb = tid; tb < TB; tb += blockDim.x) any_local |= a.t_any[(size_t)m * TB + tb] != 0;
  const bool any = vtt_block_any(any_local, &s_flag);
  vtt_block_topk(
      [&](int c, float& v, int& i) {
        v = tv[c];
        i = ti[c];
      },
      TB * K, K, s_v, s_i, s_p, s_kv, s_ki, s_kp);
  if (tid < K) {
    VttPs hps{};
    if (PS) hps = vtt_ps_task(a, h.t);
    int32_t* rec = a.send + ((size_t)m * K + tid) * W;
    const int g = s_ki[tid];
    int flags = any ? RF_BLOCK_ANY : 0;
    for (int w = RW_TC; w < W; ++w) rec[w] = 0;
    if (g != 0x7fffffff) {
      const int ln = g - (int)a.n0;
      bool fit_i;
      const bool feasible = vtt_node_feasible<PS>(a, ln, h, hps, fit_i);
      flags |= (feasible ? RF_FEASIBLE : 0) | (fit_i ? RF_FIT_IDLE : 0);
      rec[RW_TC] = a.task_count[ln];
      rec[RW_CAP] = a.node_max_tasks[ln];
      for (int r = 0; r < R; ++r) {
        rec[RW_IDLE + r] = __float_as_int(a.idle[(size_t)ln * R + r]);
        rec[RW_IDLE + R + r] = __float_as_int(a.releasing[(size_t)ln * R + r]);
      }
    }
    rec[RW_VAL] = __float_as_int(s_kv[tid]);
    rec[RW_ROW] = g;
    rec[RW_FLAGS] = flags;
  }
}

// one CTA per selected job (replicated): the job's top-K from every
// block's records, per-target counts and the job's P proposals
template <bool PS>
__global__ void __launch_bounds__(VTT_PROPOSE_THREADS)
    vtt_batch_propose(VttSolveArgs a) {
  __shared__ float s_v[VTT_PROPOSE_THREADS];
  __shared__ int s_i[VTT_PROPOSE_THREADS];
  __shared__ int s_p[VTT_PROPOSE_THREADS];
  __shared__ float s_kv[VTT_MAX_P];
  __shared__ int s_ki[VTT_MAX_P];
  __shared__ int s_kp[VTT_MAX_P];
  __shared__ int s_knode[VTT_MAX_P];
  __shared__ int s_krec[VTT_MAX_P];
  __shared__ uint8_t s_kidle[VTT_MAX_P];
  __shared__ float s_cnt[VTT_MAX_P];
  __shared__ float s_cum[VTT_MAX_P];
  __shared__ int s_flag;

  const int tid = threadIdx.x;
  const int m = blockIdx.x;
  const int R = (int)a.R, T = (int)a.T, P = (int)a.P, K = (int)a.K,
            M = (int)a.M, S = (int)a.S, W = (int)a.W;
  const VttHead h = vtt_head(a, m);
  if (h.j < 0) {
    for (int p = tid; p < P; p += blockDim.x) {
      const int f = m * P + p;
      a.p_flags[f] = 0;
      a.p_node[f] = 0;
      a.p_t[f] = 0;
      a.p_job[f] = -1;
      a.p_rec[f] = 0;
    }
    return;
  }
  const int j = h.j;
  // candidate c = (block s, slot k): record (s * M + m) * K + k
  auto rec_of = [&](int c) { return ((size_t)(c / K) * M + m) * K + c % K; };
  bool any_local = false;
  for (int s = tid; s < S; s += blockDim.x)
    any_local |= (a.recv[rec_of(s * K) * W + RW_FLAGS] & RF_BLOCK_ANY) != 0;
  const bool job_ok = vtt_block_any(any_local, &s_flag);
  vtt_block_topk(
      [&](int c, float& v, int& i) {
        const int32_t* rec = a.recv + rec_of(c) * W;
        v = __int_as_float(rec[RW_VAL]);
        i = rec[RW_ROW];
      },
      S * K, K, s_v, s_i, s_p, s_kv, s_ki, s_kp);
  VttPs hps{};
  if (PS) hps = vtt_ps_task(a, h.t);

  // rotate by rank, per-target task counts
  if (tid < K) {
    const int k = tid;
    const int ri = (int)rec_of(s_kp[(k + m % K) % K]);
    const int32_t* rec = a.recv + (size_t)ri * W;
    const bool feasible = (rec[RW_FLAGS] & RF_FEASIBLE) != 0;
    const bool is_idle = (rec[RW_FLAGS] & RF_FIT_IDLE) && feasible;
    float c = VTT_POS_INF;
    for (int r = 0; r < R; ++r)
      if (h.req[r] > 0.0f)
        c = fminf(c, floorf((__int_as_float(rec[RW_IDLE + r]) + a.eps[r]) /
                            fmaxf(h.req[r], 1e-30f)));
    c = is_idle ? fmaxf(c, 0.0f) : 0.0f;
    if (feasible && !is_idle) c = 1.0f;
    if (PS) {
      // a head with ports or self-matching anti-affinity: one task a node
      bool self_anti = false;
      for (int w = 0; w < VTT_SW; ++w) self_anti |= (hps.anti[w] & hps.self_[w]) != 0;
      if (hps.any_port || self_anti) c = fminf(c, 1.0f);
    }
    s_knode[k] = rec[RW_ROW];
    s_krec[k] = ri;
    s_kidle[k] = is_idle ? 1 : 0;
    s_cnt[k] = c;
  }
  __syncthreads();
  if (tid == 0) {
    float cum = 0.0f;
    for (int k = 0; k < K; ++k) {
      cum = k == 0 ? s_cnt[0] : cum + s_cnt[k];
      s_cum[k] = cum;
    }
  }
  __syncthreads();
  if (tid < P) {
    const int p = tid;
    const int f = m * P + p;
    int slot = 0;
    for (int k = 0; k < K; ++k) slot += ((float)p >= s_cum[k]) ? 1 : 0;
    const bool in_range = slot < K;
    const int sc = slot < K ? slot : K - 1;
    const int node = s_knode[sc];
    const int32_t* rec = a.recv + (size_t)s_krec[sc] * W;
    const bool valid = job_ok && (h.cursor + p < a.job_ntasks[j]) && in_range;
    const int t = vtt_clampi(a.job_start[j] + h.cursor + p, 0, T - 1);
    const bool is_idle = s_kidle[sc] && valid;
    const bool is_pipe = valid && !is_idle;
    bool pipe_fits = rec[RW_TC] < rec[RW_CAP];
    for (int r = 0; r < R; ++r)
      pipe_fits = pipe_fits && (a.task_req[(size_t)t * R + r] <
                                __int_as_float(rec[RW_IDLE + R + r]) + a.eps[r]);
    // a proposal whose OWN task has ports or anti selectors never pipelines
    // (pipe wins bypass the accept kernel's conflict scan)
    bool ps_pipe_ok = true;
    if (PS) {
      const VttPs tps = vtt_ps_task(a, t);
      ps_pipe_ok = !tps.any_port && !(tps.anti[0] | tps.anti[1]);
    }
    const bool pipe_ok = is_pipe && pipe_fits && ps_pipe_ok;
    a.p_node[f] = node;
    a.p_t[f] = t;
    a.p_job[f] = j;
    a.p_rec[f] = s_krec[sc];
    a.p_flags[f] = (valid ? PF_VALID : 0) | (is_idle ? PF_IDLE : 0) |
                   (pipe_ok ? PF_PIPE : 0);
    if (pipe_ok) atomicMin(&a.best_pipe[node], f);
  }
}

// Threads of vtt_batch_sort: 512 past 8,192 proposals, so that the shared
// memory below stays inside the card's 227 KB at 16,384.
static int vtt_sort_threads(int F) { return F > 8192 ? 512 : VTT_ONE_CTA_THREADS; }

// Shared memory of vtt_batch_sort for F proposals on nthr threads: two
// buffers of node keys (u32) and flat indices (u16), and a 16-digit x
// nthr table of counters (u16).
static size_t vtt_sort_smem(int F, int nthr) {
  const size_t fp = (size_t)((F + nthr - 1) / nthr) * nthr;
  return fp * 2 * (sizeof(uint32_t) + sizeof(uint16_t)) + 16 * (size_t)nthr * sizeof(uint16_t);
}

// one CTA (replicated): the F proposals in (node, flat index) order into
// p_key -- a stable LSD radix sort, 4 bits a pass, on the node (N for a
// proposal that does not take idle capacity) of the proposals in flat
// order.  Thread t holds the proposals [t * ipt, (t + 1) * ipt) in every
// pass; a pass counts each thread's digits in its own column of the
// counter table, scans the table digit-major, and scatters each thread's
// proposals in order: stable, so the flat order survives within a node.
__global__ void __launch_bounds__(VTT_ONE_CTA_THREADS) vtt_batch_sort(VttSolveArgs a) {
  VTT_DYN_SMEM(uint32_t, s_buf);
  __shared__ int s_part[VTT_ONE_CTA_THREADS];
  __shared__ int s_tot[33];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int F = (int)a.F, N = (int)a.N;
  const int ipt = (F + nthr - 1) / nthr, fp = ipt * nthr;
  uint32_t* kin = s_buf;
  uint32_t* kout = s_buf + fp;
  uint16_t* vin = reinterpret_cast<uint16_t*>(s_buf + 2 * fp);
  uint16_t* vout = vin + fp;
  uint16_t* cnt = vout + fp;
  const int lo = min(F, tid * ipt), hi = min(F, lo + ipt);
  for (int f = lo; f < hi; ++f) {
    kin[f] = (a.p_flags[f] & PF_IDLE) ? (uint32_t)a.p_node[f] : (uint32_t)N;
    vin[f] = (uint16_t)f;
  }
  const int passes = (32 - __clz(N) + 3) / 4;  // the bits of N, 4 a pass
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 4 * pass;
    for (int d = 0; d < 16; ++d) cnt[d * nthr + tid] = 0;
    for (int i = lo; i < hi; ++i) ++cnt[((kin[i] >> shift) & 15u) * nthr + tid];
    __syncthreads();
    // exclusive scan of the table, digit-major: thread t its 16 entries
    int c16 = 0;
    for (int e = 0; e < 16; ++e) c16 += cnt[tid * 16 + e];
    int total;
    int run = vtt_block_scan(c16, s_part, s_tot, total);
    for (int e = 0; e < 16; ++e) {
      const int c = cnt[tid * 16 + e];
      cnt[tid * 16 + e] = (uint16_t)run;
      run += c;
    }
    __syncthreads();
    for (int i = lo; i < hi; ++i) {
      const uint32_t k = kin[i];
      const int pos = cnt[((k >> shift) & 15u) * nthr + tid]++;
      kout[pos] = k;
      vout[pos] = vin[i];
    }
    __syncthreads();
    uint32_t* kt = kin;
    kin = kout;
    kout = kt;
    uint16_t* vt = vin;
    vin = vout;
    vout = vt;
  }
  for (int i = tid; i < F; i += nthr)
    a.p_key[i] = ((unsigned long long)kin[i] << 32) | (unsigned long long)vin[i];
}

// one thread per node segment of p_key (replicated, over the card): the
// running request sum against the record's idle + eps and its pod cap,
// and K5's running port and label words
template <bool PS>
__global__ void __launch_bounds__(VTT_WIDE_THREADS) vtt_batch_seg(VttSolveArgs a) {
  const int N = (int)a.N, R = (int)a.R, F = (int)a.F, W = (int)a.W;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F) return;
  const int kn = (int)(a.p_key[i] >> 32);
  if (kn >= N || (i > 0 && (int)(a.p_key[i - 1] >> 32) == kn)) return;
  float run[VTT_MAX_R];
  for (int r = 0; r < R; ++r) run[r] = 0.0f;
  // K5: ports and labels of every earlier proposal in this node's run
  uint32_t run_ports[VTT_PW] = {0, 0, 0, 0}, run_self[VTT_SW] = {0, 0};
  const int32_t* rec = a.recv + (size_t)a.p_rec[(int)(a.p_key[i] & 0xffffffffu)] * W;
  const int tc = rec[RW_TC], cap = rec[RW_CAP];
  int pos = 0;
  for (int i2 = i; i2 < F && (int)(a.p_key[i2] >> 32) == kn; ++i2, ++pos) {
    const int f = (int)(a.p_key[i2] & 0xffffffffu);
    const float* rq = &a.task_req[(size_t)a.p_t[f] * R];
    bool ok = true;
    for (int r = 0; r < R; ++r) {
      run[r] = run[r] + rq[r];
      ok = ok && (run[r] < __int_as_float(rec[RW_IDLE + r]) + a.eps[r]);
    }
    if (PS) {
      const VttPs tps = vtt_ps_task(a, a.p_t[f]);
      for (int w = 0; w < VTT_PW; ++w) {
        ok = ok && !(run_ports[w] & tps.port[w]);
        run_ports[w] |= tps.port[w];
      }
      for (int w = 0; w < VTT_SW; ++w) {
        ok = ok && !(run_self[w] & tps.anti[w]);
        run_self[w] |= tps.self_[w];
      }
    }
    if (ok && tc + pos < cap) a.p_flags[f] |= PF_ACCEPT;
  }
}

// one thread per selected job (replicated, over the card): its proposals'
// wins (accepted on idle capacity, or the node's best pipeline), cut at
// the first loss of its offsets, and the job and task updates in offset
// order
__global__ void __launch_bounds__(VTT_WIDE_THREADS) vtt_batch_jobs(VttSolveArgs a) {
  const int R = (int)a.R, T = (int)a.T, P = (int)a.P, F = (int)a.F;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= a.M) return;
  int32_t* task_node = a.packed;
  int32_t* task_kind = a.packed + T;
  int32_t* task_seq = a.packed + 2 * T;
  int32_t* ready = a.packed + 3 * T;
  const int round = a.ctl[0];
  bool ok = true;
  for (int p = 0; p < P && ok; ++p) {
    const int f = m * P + p;
    const uint8_t fl = a.p_flags[f];
    const bool ui = (fl & PF_ACCEPT) != 0;
    ok = ui || ((fl & PF_PIPE) && a.best_pipe[a.p_node[f]] == f);
    if (!ok) break;
    a.p_flags[f] = fl | PF_WIN | (ui ? PF_USE_IDLE : 0);
    const int j = a.p_job[f];
    const int t = a.p_t[f];
    for (int r = 0; r < R; ++r)
      a.job_alloc[(size_t)j * R + r] =
          a.job_alloc[(size_t)j * R + r] + a.task_req[(size_t)t * R + r];
    ready[j] += ui ? 1 : 0;
    a.cursor[j] += 1;
    task_node[t] = a.p_node[f];
    task_kind[t] = ui ? 1 : 2;
    task_seq[t] = round * F + f;
  }
}

// Shared memory of vtt_batch_queue: the winners' flat indices [F], then a
// tile's queues [VTT_QTILE] and requests [VTT_QTILE, R].
static size_t vtt_queue_smem(int F, int R) {
  return ((size_t)F + VTT_QTILE) * sizeof(int) + (size_t)VTT_QTILE * R * sizeof(float);
}

// one CTA (replicated): the winners compacted in flat order (a block
// scan), the queue shares added in that order by one thread per (queue,
// resource) over tiles staged in shared memory, and the no-win drop
__global__ void __launch_bounds__(VTT_ONE_CTA_THREADS) vtt_batch_queue(VttSolveArgs a) {
  VTT_DYN_SMEM(int, s_wf);
  __shared__ int s_part[VTT_ONE_CTA_THREADS];
  __shared__ int s_tot[33];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int R = (int)a.R, T = (int)a.T, Q = (int)a.Q, F = (int)a.F;
  int* s_q = s_wf + F;
  float* s_rq = reinterpret_cast<float*>(s_q + VTT_QTILE);
  const int ipt = (F + nthr - 1) / nthr;
  const int lo = min(F, tid * ipt), hi = min(F, lo + ipt);
  int c = 0;
  for (int f = lo; f < hi; ++f) c += (a.p_flags[f] & PF_WIN) ? 1 : 0;
  int nw;
  int at = vtt_block_scan(c, s_part, s_tot, nw);
  for (int f = lo; f < hi; ++f)
    if (a.p_flags[f] & PF_WIN) s_wf[at++] = f;
  __syncthreads();
  for (int base = 0; base < nw; base += VTT_QTILE) {
    const int n = min(VTT_QTILE, nw - base);
    for (int k = tid; k < n; k += nthr) {
      const int f = s_wf[base + k];
      const int t = a.p_t[f];
      s_q[k] = vtt_clampi(a.job_queue[a.p_job[f]], 0, Q - 1);
      for (int r = 0; r < R; ++r) s_rq[k * R + r] = a.task_req[(size_t)t * R + r];
    }
    __syncthreads();
    for (int qr = tid; qr < Q * R; qr += nthr) {
      const int q = qr / R, r = qr - q * R;
      float acc = a.queue_alloc[qr];
#pragma unroll 8
      for (int k = 0; k < n; ++k)
        if (s_q[k] == q) acc = acc + s_rq[k * R + r];
      a.queue_alloc[qr] = acc;
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int32_t* ready = a.packed + 3 * T;
    const bool any_win = nw > 0;
    const int n_active = a.ctl[1];
    const bool do_evict = !any_win && n_active > 0;
    a.ctl[4] = -1;
    if (do_evict) {
      const int v = a.ctl[3];
      a.dropped[v] = 1;
      // the gang's session placements unwind in vtt_batch_rollback (node
      // rows, per block) and vtt_batch_finish (tasks, job, queue)
      if (a.use_gang_ready && ready[v] < a.job_min[v]) a.ctl[4] = v;
    }
    a.ctl[2] = (any_win || do_evict) ? 1 : 0;
    a.ctl[0] += 1;
    a.ctl[1] = 0;
  }
}

// a thread per node segment of the block's rows: the idle wins in rank
// order
template <bool PS>
__global__ void __launch_bounds__(VTT_WIDE_THREADS) vtt_batch_apply_idle(VttSolveArgs a) {
  const int N = (int)a.N, R = (int)a.R, F = (int)a.F;
  const int n0 = (int)a.n0, NB = (int)a.NB;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F) return;
  const int kn = (int)(a.p_key[i] >> 32);
  if (kn >= N || (i > 0 && (int)(a.p_key[i - 1] >> 32) == kn)) return;
  const int ln = kn - n0;
  if (ln < 0 || ln >= NB) return;
  for (int i2 = i; i2 < F && (int)(a.p_key[i2] >> 32) == kn; ++i2) {
    const int f = (int)(a.p_key[i2] & 0xffffffffu);
    if (!(a.p_flags[f] & PF_USE_IDLE)) continue;
    const float* rq = &a.task_req[(size_t)a.p_t[f] * R];
    for (int r = 0; r < R; ++r) {
      a.idle[(size_t)ln * R + r] = a.idle[(size_t)ln * R + r] - rq[r];
      a.used[(size_t)ln * R + r] = a.used[(size_t)ln * R + r] + rq[r];
    }
    a.task_count[ln] += 1;
    if (PS) vtt_ps_fold(a, ln, vtt_ps_task(a, a.p_t[f]), +1);
  }
}

// a thread per proposal: the pipeline wins on the block's rows (at most
// one a node), after its idle wins
template <bool PS>
__global__ void __launch_bounds__(VTT_WIDE_THREADS) vtt_batch_apply_pipe(VttSolveArgs a) {
  const int R = (int)a.R, F = (int)a.F;
  const int n0 = (int)a.n0, NB = (int)a.NB;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const uint8_t fl = a.p_flags[f];
  if (!(fl & PF_WIN) || (fl & PF_USE_IDLE)) return;
  const int ln = a.p_node[f] - n0;
  if (ln < 0 || ln >= NB) return;
  const float* rq = &a.task_req[(size_t)a.p_t[f] * R];
  for (int r = 0; r < R; ++r) {
    a.releasing[(size_t)ln * R + r] = a.releasing[(size_t)ln * R + r] - rq[r];
    a.used[(size_t)ln * R + r] = a.used[(size_t)ln * R + r] + rq[r];
  }
  a.task_count[ln] += 1;
  // a pipe win has no ports or anti bits, but its labels count
  if (PS) vtt_ps_fold(a, ln, vtt_ps_task(a, a.p_t[f]), +1);
}

// one thread per block: unwind the dropped gang's placements on the
// block's rows, in task order (its task rows are contiguous)
template <bool PS>
__global__ void vtt_batch_rollback(VttSolveArgs a) {
  const int v = a.ctl[4];
  if (v < 0) return;
  const int N = (int)a.N, R = (int)a.R, T = (int)a.T;
  const int n0 = (int)a.n0, NB = (int)a.NB;
  const int32_t* task_node = a.packed;
  const int32_t* task_kind = a.packed + T;
  const int t0 = a.job_start[v], t1 = t0 + a.job_ntasks[v];
  for (int t = t0; t < t1; ++t) {
    const int kind = task_kind[t];
    if (kind <= 0 || !a.task_valid[t] || a.task_job[t] != v) continue;
    const int ln = vtt_clampi(task_node[t], 0, N - 1) - n0;
    if (ln < 0 || ln >= NB) continue;
    const float* rq = &a.task_req[(size_t)t * R];
    float* back = kind == 1 ? &a.idle[(size_t)ln * R] : &a.releasing[(size_t)ln * R];
    for (int r = 0; r < R; ++r) {
      back[r] = back[r] + rq[r];
      a.used[(size_t)ln * R + r] = a.used[(size_t)ln * R + r] - rq[r];
    }
    a.task_count[ln] -= 1;
    if (PS) vtt_ps_fold(a, ln, vtt_ps_task(a, t), -1);
  }
}

// one thread (replicated): the rolled-back gang's task rows, job state and
// queue share
__global__ void vtt_batch_finish(VttSolveArgs a) {
  const int v = a.ctl[4];
  if (v < 0) return;
  const int R = (int)a.R, T = (int)a.T, Q = (int)a.Q;
  int32_t* task_node = a.packed;
  int32_t* task_kind = a.packed + T;
  int32_t* task_seq = a.packed + 2 * T;
  int32_t* ready = a.packed + 3 * T;
  float qsum[VTT_MAX_R];
  for (int r = 0; r < R; ++r) qsum[r] = 0.0f;
  const int t0 = a.job_start[v], t1 = t0 + a.job_ntasks[v];
  for (int t = t0; t < t1; ++t) {
    if (task_kind[t] <= 0 || !a.task_valid[t] || a.task_job[t] != v) continue;
    for (int r = 0; r < R; ++r) qsum[r] = qsum[r] + a.task_req[(size_t)t * R + r];
    task_node[t] = -1;
    task_kind[t] = 0;
    task_seq[t] = -1;
  }
  for (int r = 0; r < R; ++r) a.job_alloc[(size_t)v * R + r] = a.job_alloc_init[(size_t)v * R + r];
  ready[v] = a.job_ready_init[v];
  a.cursor[v] = 0;
  const int qv = vtt_clampi(a.job_queue[v], 0, Q - 1);
  for (int r = 0; r < R; ++r)
    a.queue_alloc[(size_t)qv * R + r] = a.queue_alloc[(size_t)qv * R + r] - qsum[r];
  a.ctl[4] = -1;
}

static int vtt_check() { return (int)cudaGetLastError(); }

static int vtt_batch_ok(const VttSolveArgs& a) {
  return a.R >= 2 && a.R <= VTT_MAX_R && a.P >= 1 && a.P <= VTT_MAX_P && a.K <= a.P &&
         a.K >= 1 && a.n_keys <= 3 && a.F == a.M * a.P && a.F <= 65536 && !a.has_volsel &&
         a.S >= 1 && a.NB >= 1 && a.TILE >= 1 && a.TILE <= VTT_TILE_MAX &&
         a.TB * a.TILE >= a.NB && a.W == 5 + 2 * a.R &&
         a.nC == (a.J + VTT_SEL_CHUNK - 1) / VTT_SEL_CHUNK;
}

template <bool PS>
static int vtt_batch_begin_t(const VttSolveArgs& a, cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(vtt_batch_tiles<PS>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)(a.TILE * sizeof(float)));
  if (err) return err;
  const int F = (int)a.F;
  err = (int)cudaFuncSetAttribute(vtt_batch_sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)vtt_sort_smem(F, vtt_sort_threads(F)));
  if (err) return err;
  err = (int)cudaFuncSetAttribute(vtt_batch_queue, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)vtt_queue_smem((int)a.F, (int)a.R));
  if (err) return err;
  VTT_LAUNCH(vtt_batch_init, 1, 1, 0, s)(a);
  return vtt_check();
}

static void vtt_batch_keys_launch(const VttSolveArgs& a, cudaStream_t s) {
  int64_t wide = a.N + 1 > a.J ? a.N + 1 : a.J;
  if (a.M > wide) wide = a.M;
  VTT_LAUNCH(vtt_batch_keys, (int)((wide + 255) / 256), 256, 0, s)(a);
}

// Start a solve: the base (replicated) arguments, then each local block's
// (K5's per-block node_match).  Leaves the first round's go flag in ctl[1].
extern "C" int vtt_batch_begin(const VttSolveArgs* base, const VttSolveArgs* blocks,
                               int n_blocks, void* stream) {
  const VttSolveArgs& a = *base;
  if (!vtt_batch_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = a.has_portsel ? vtt_batch_begin_t<true>(a, s) : vtt_batch_begin_t<false>(a, s);
  if (err) return err;
  for (int b = 0; b < n_blocks; ++b) {
    if (!vtt_batch_ok(blocks[b])) return (int)cudaErrorInvalidValue;
    if (a.has_portsel)
      VTT_LAUNCH(vtt_ps_init, (int)((blocks[b].NB + 255) / 256), 256, 0, s)(blocks[b]);
  }
  vtt_batch_keys_launch(a, s);
  return vtt_check();
}

template <bool PS>
static void vtt_batch_candidates_t(const VttSolveArgs& a, const VttSolveArgs* blocks,
                                   int n_blocks, cudaStream_t s) {
  const int nC = (int)a.nC, kept = (int)(a.nC * a.M);
  VTT_LAUNCH(vtt_batch_chunk, nC, VTT_SEL_THREADS, 0, s)(a);
  if (nC > 1) {
    const unsigned wide = (unsigned)((kept + VTT_WIDE_THREADS - 1) / VTT_WIDE_THREADS);
    VTT_LAUNCH(vtt_batch_merge, dim3(wide, (unsigned)nC), VTT_WIDE_THREADS, 0, s)(a);
    VTT_LAUNCH(vtt_batch_place, (int)wide, VTT_WIDE_THREADS, 0, s)(a);
  }
  for (int b = 0; b < n_blocks; ++b) {
    const VttSolveArgs& blk = blocks[b];
    VTT_LAUNCH(vtt_batch_tiles<PS>, dim3((unsigned)blk.M, (unsigned)blk.TB),
               VTT_PROPOSE_THREADS, blk.TILE * sizeof(float), s)(blk);
    VTT_LAUNCH(vtt_batch_pack<PS>, (int)blk.M, VTT_PROPOSE_THREADS, 0, s)(blk);
  }
}

// The first half of a round: select the jobs, then each local
// block's tile pass and records (into its slot of `send`).
extern "C" int vtt_batch_candidates(const VttSolveArgs* base, const VttSolveArgs* blocks,
                                    int n_blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (base->has_portsel)
    vtt_batch_candidates_t<true>(*base, blocks, n_blocks, s);
  else
    vtt_batch_candidates_t<false>(*base, blocks, n_blocks, s);
  return vtt_check();
}

template <bool PS>
static void vtt_batch_decide_t(const VttSolveArgs& a, const VttSolveArgs* blocks,
                               int n_blocks, cudaStream_t s) {
  const int F = (int)a.F;
  const int wide_f = (F + VTT_WIDE_THREADS - 1) / VTT_WIDE_THREADS;
  VTT_LAUNCH(vtt_batch_propose<PS>, (int)a.M, VTT_PROPOSE_THREADS, 0, s)(a);
  VTT_LAUNCH(vtt_batch_sort, 1, vtt_sort_threads(F), vtt_sort_smem(F, vtt_sort_threads(F)),
             s)(a);
  VTT_LAUNCH(vtt_batch_seg<PS>, wide_f, VTT_WIDE_THREADS, 0, s)(a);
  VTT_LAUNCH(vtt_batch_jobs, (int)((a.M + VTT_WIDE_THREADS - 1) / VTT_WIDE_THREADS),
             VTT_WIDE_THREADS, 0, s)(a);
  VTT_LAUNCH(vtt_batch_queue, 1, VTT_ONE_CTA_THREADS, vtt_queue_smem(F, (int)a.R), s)(a);
  for (int b = 0; b < n_blocks; ++b) {
    VTT_LAUNCH(vtt_batch_apply_idle<PS>, wide_f, VTT_WIDE_THREADS, 0, s)(blocks[b]);
    VTT_LAUNCH(vtt_batch_apply_pipe<PS>, wide_f, VTT_WIDE_THREADS, 0, s)(blocks[b]);
    VTT_LAUNCH(vtt_batch_rollback<PS>, 1, 1, 0, s)(blocks[b]);
  }
  VTT_LAUNCH(vtt_batch_finish, 1, 1, 0, s)(a);
  vtt_batch_keys_launch(a, s);
}

// The second half of a round, after the exchange filled `recv`: the
// replicated decision, each local block's apply, the rollback's replicated
// part and the next round's keys (and go flag).
extern "C" int vtt_batch_decide(const VttSolveArgs* base, const VttSolveArgs* blocks,
                                int n_blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (base->has_portsel)
    vtt_batch_decide_t<true>(*base, blocks, n_blocks, s);
  else
    vtt_batch_decide_t<false>(*base, blocks, n_blocks, s);
  return vtt_check();
}
