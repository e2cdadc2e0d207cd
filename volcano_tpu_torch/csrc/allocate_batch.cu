// K3: the batched-rounds allocate solve, one round = five kernels.
//
// Replaces volcano_tpu/scheduler/kernels.py:491 `allocate_solve_batch`
// (portsel=None, exact_topk=True).  Each round: rank the jobs by the tier
// key, let the top M propose their next P tasks over their K best nodes,
// accept the (node, rank)-ordered proposals whose running request sum fits
// the node, apply the winners, and drop (with gang rollback) the
// lowest-ranked job when nothing won.
//
// What bounds it on the H100: per round, the [M, N] head-task score pass
// (M = 512 jobs x N = 16384 nodes, ~40 bytes and ~30 flops a cell, all
// from L2) and the O(J^2) job ranking; both are far below the card's
// rates, so the round is bound by its launches and barriers, and the
// solve by its round count.  Design:
//   * the host runs the round loop and reads ONE 4-byte flag a round: the
//     active-job count, which vtt_batch_keys accumulates only when the
//     last round progressed (the reference's `progressed & any(active)`);
//   * vtt_batch_rank counts, for each active job, the active jobs with a
//     smaller key tuple (jidx last, so all keys are distinct) — the rank,
//     with no sort;
//   * vtt_batch_propose runs one CTA per selected job: the job's scores
//     never leave shared memory, and K passes of a block-wide first-max
//     take lax.top_k's order (values descending, lower index first);
//   * vtt_batch_accept is one CTA: a bitonic sort of the F = M*P proposals
//     by (node, rank), one thread per node segment for the running sums,
//     and every state update in a fixed order.  Float sums never use
//     atomics (integer atomicMin picks the best pipeline rank per node).
//
// K5 in K3 (has_portsel): replaces the portsel branches of the same
// function: the [M, N] port / required / anti feasibility and the interpod
// score (kernels.py:611-635), the one-task-per-target spread of heads with
// ports or self-matching anti-affinity (:702-710), the segmented exclusive
// cumulative-OR conflict scan (:763-793), the pipe exclusion of proposals
// with ports or anti selectors (:805-811), the scatter-OR / scatter-add of
// winners' ports and labels (:862-881) and the rollback's scatter-AND and
// subtract (:935-943); the on-device unpack of tensor_actions.py:664-684
// has no launch here, the words are tested in place.  Design: the propose
// kernel tests a head's words against each node's port words and a
// per-node "selector matched" word pair (kept beside the counts, refreshed
// wherever a count moves) — no matrix products, no per-node shared arrays;
// the accept kernel's one-thread-per-node-segment walk, which already
// visits each node's proposals in rank order, carries six running words
// (4 of ports, 2 of labels) and ORs in every proposal, accepted or not,
// as the reference's scan does; the owners of a node's idle run, pipe win
// and rollback fold ports and counts into that node.  Bound: as K3; K5
// adds 24 bytes a (job, node) pair to the score pass's L2 reads, and only
// for heads that carry ports or selectors.  The propose and accept kernels
// are templates on the flag: without portsel no K5 code is compiled in.
#include "common.cuh"

#define VTT_PROPOSE_THREADS 256
#define VTT_ACCEPT_THREADS 1024
#define VTT_RANK_CHUNK 1024
#define VTT_MAX_P 32

// p_flags bits
#define PF_VALID 1
#define PF_IDLE 2
#define PF_PIPE 4
#define PF_ACCEPT 8
#define PF_RAW 16
#define PF_WIN 32
#define PF_USE_IDLE 64

__device__ __forceinline__ int vtt_clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ bool vtt_rank_less(const float* ka, int ia,
                                              const float* kb, int ib, int nk) {
  for (int i = 0; i < nk; ++i) {
    if (ka[i] < kb[i]) return true;
    if (ka[i] > kb[i]) return false;
  }
  return ia < ib;
}

// node_match from node_selcnt, once per solve (K5)
__global__ void vtt_ps_init(VttSolveArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < a.N) vtt_ps_init_node(a, n);
}

__global__ void vtt_batch_init(VttSolveArgs a) {
  a.ctl[0] = 0;  // rounds
  a.ctl[1] = 0;  // active jobs if the last round progressed, else 0
  a.ctl[2] = 1;  // progressed
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
  a.job_rank[j] = 0;
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

// rank_j = #{active i : key_i < key_j}; blockIdx.y picks a chunk of i
__global__ void vtt_batch_rank(VttSolveArgs a) {
  __shared__ float s_keys[VTT_RANK_CHUNK * 4];
  __shared__ uint8_t s_act[VTT_RANK_CHUNK];
  const int J = (int)a.J;
  const int nk = (int)(a.n_keys + (a.use_proportion ? 1 : 0));
  const int c0 = blockIdx.y * VTT_RANK_CHUNK;
  const int cn = min(VTT_RANK_CHUNK, J - c0);
  for (int i = threadIdx.x; i < cn; i += blockDim.x) {
    s_act[i] = a.job_active[c0 + i];
    for (int k = 0; k < 4; ++k) s_keys[i * 4 + k] = a.job_keys[(size_t)(c0 + i) * 4 + k];
  }
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J || !a.job_active[j]) return;
  float kj[4];
  for (int k = 0; k < 4; ++k) kj[k] = a.job_keys[(size_t)j * 4 + k];
  int cnt = 0;
  for (int i = 0; i < cn; ++i)
    if (s_act[i] && vtt_rank_less(&s_keys[i * 4], c0 + i, kj, j, nk)) ++cnt;
  if (cnt) atomicAdd(&a.job_rank[j], cnt);
}

// sel[rank] = job for the top M; the lowest-ranked active job is the victim
__global__ void vtt_batch_select(VttSolveArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.J || !a.job_active[j]) return;
  const int r = a.job_rank[j];
  if (r < a.M) a.sel[r] = j;
  if (r == a.ctl[1] - 1) a.ctl[3] = j;
}

// one CTA per selected job: head-task scores over all nodes in shared
// memory, exact top-K, per-target counts and the job's P proposals
template <bool PS>
__global__ void __launch_bounds__(VTT_PROPOSE_THREADS)
    vtt_batch_propose(VttSolveArgs a) {
  VTT_DYN_SMEM(float, s_val);
  __shared__ float s_v[VTT_PROPOSE_THREADS];
  __shared__ int s_i[VTT_PROPOSE_THREADS];
  __shared__ int s_top[VTT_MAX_P];
  __shared__ int s_knode[VTT_MAX_P];
  __shared__ uint8_t s_kidle[VTT_MAX_P];
  __shared__ float s_cnt[VTT_MAX_P];
  __shared__ float s_cum[VTT_MAX_P];
  __shared__ int s_flag;

  const int tid = threadIdx.x;
  const int m = blockIdx.x;
  const int N = (int)a.N, R = (int)a.R, T = (int)a.T, P = (int)a.P,
            K = (int)a.K;
  const int j = a.sel[m];
  if (j < 0) {
    for (int p = tid; p < P; p += blockDim.x) {
      const int f = m * P + p;
      a.p_flags[f] = 0;
      a.p_node[f] = 0;
      a.p_t[f] = 0;
      a.p_job[f] = -1;
    }
    return;
  }
  const int cursor = a.cursor[j];
  const int head_t = vtt_clampi(a.job_start[j] + cursor, 0, T - 1);
  float req[VTT_MAX_R];
  for (int r = 0; r < R; ++r) req[r] = a.task_req[(size_t)head_t * R + r];
  const int cls = a.task_class[head_t];
  const uint8_t* cmask = a.class_mask + (size_t)cls * N;
  const float* cscore = a.class_score + (size_t)cls * N;
  const uint32_t jh = (uint32_t)j * 2654435761u;
  const float jscale = (float)(1e-4 / 65535.0);
  VttPs hps{};
  if (PS) hps = vtt_ps_task(a, head_t);

  bool any_local = false;
  for (int n = tid; n < N; n += blockDim.x) {
    const bool fit_i = vtt_less_equal(req, &a.idle[(size_t)n * R], a.eps, R);
    const bool fit_r = vtt_less_equal(req, &a.releasing[(size_t)n * R], a.eps, R);
    const bool feasible = (fit_i || fit_r) && cmask[n] &&
                          a.task_count[n] < a.node_max_tasks[n] && a.node_valid[n] &&
                          (!PS || vtt_ps_feasible(a, n, hps));
    float v = VTT_NEG_INF;
    if (feasible) {
      float sc = vtt_score_node(req, &a.used[(size_t)n * R],
                                &a.node_alloc[(size_t)n * R], cscore[n],
                                a.w_least, a.w_balanced);
      if (PS) sc = vtt_ps_score(a, n, hps, sc);
      uint32_t h = (jh ^ ((uint32_t)n * 40503u)) * 2246822519u;
      h ^= h >> 15;
      v = __fmaf_rn((float)(h & 0xFFFFu), jscale, sc);
      any_local = true;
    }
    s_val[n] = v;
  }
  const bool job_ok = vtt_block_any(any_local, &s_flag);

  // exact top-K: K passes, each the first-max among entries ranked after
  // the previous pass's winner
  float prev_v = VTT_POS_INF;
  int prev_i = -1;
  for (int k = 0; k < K; ++k) {
    float bv = VTT_NEG_INF;
    int bi = 0x7fffffff;
    for (int n = tid; n < N; n += blockDim.x) {
      const float v = s_val[n];
      if ((k == 0 || vtt_better(prev_v, prev_i, v, n)) && vtt_better(v, n, bv, bi)) {
        bv = v;
        bi = n;
      }
    }
    vtt_block_argmax(bv, bi, s_v, s_i);
    if (tid == 0) s_top[k] = bi;
    prev_v = bv;
    prev_i = bi;
  }
  __syncthreads();

  // rotate by rank, per-target task counts
  if (tid < K) {
    const int k = tid;
    const int node = s_top[(k + m % K) % K];
    const float* nid = &a.idle[(size_t)node * R];
    const bool fit_i = vtt_less_equal(req, nid, a.eps, R);
    const bool fit_r = vtt_less_equal(req, &a.releasing[(size_t)node * R], a.eps, R);
    const bool feasible = (fit_i || fit_r) && cmask[node] &&
                          a.task_count[node] < a.node_max_tasks[node] &&
                          a.node_valid[node] &&
                          (!PS || vtt_ps_feasible(a, node, hps));
    const bool is_idle = fit_i && feasible;
    float c = VTT_POS_INF;
    for (int r = 0; r < R; ++r)
      if (req[r] > 0.0f)
        c = fminf(c, floorf((nid[r] + a.eps[r]) / fmaxf(req[r], 1e-30f)));
    c = is_idle ? fmaxf(c, 0.0f) : 0.0f;
    if (feasible && !is_idle) c = 1.0f;
    if (PS) {
      // a head with ports or self-matching anti-affinity: one task a node
      bool self_anti = false;
      for (int w = 0; w < VTT_SW; ++w) self_anti |= (hps.anti[w] & hps.self_[w]) != 0;
      if (hps.any_port || self_anti) c = fminf(c, 1.0f);
    }
    s_knode[k] = node;
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
    const bool valid = job_ok && (cursor + p < a.job_ntasks[j]) && in_range;
    const int t = vtt_clampi(a.job_start[j] + cursor + p, 0, T - 1);
    const bool is_idle = s_kidle[sc] && valid;
    const bool is_pipe = valid && !is_idle;
    const int nc = vtt_clampi(node, 0, N - 1);
    const bool pipe_fits =
        vtt_less_equal(&a.task_req[(size_t)t * R], &a.releasing[(size_t)nc * R],
                       a.eps, R) &&
        a.task_count[nc] < a.node_max_tasks[nc];
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
    a.p_flags[f] = (valid ? PF_VALID : 0) | (is_idle ? PF_IDLE : 0) |
                   (pipe_ok ? PF_PIPE : 0);
    if (pipe_ok) atomicMin(&a.best_pipe[node], f);
  }
}

// one CTA: (node, rank) order, capacity-aware acceptance, pipeline wins,
// per-job prefix cancel, state update, and the no-win drop with rollback
template <bool PS>
__global__ void __launch_bounds__(VTT_ACCEPT_THREADS)
    vtt_batch_accept(VttSolveArgs a, int Fp2) {
  VTT_DYN_SMEM(unsigned long long, s_key);
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int N = (int)a.N, R = (int)a.R, T = (int)a.T, Q = (int)a.Q,
            M = (int)a.M, P = (int)a.P, F = (int)a.F;
  int32_t* task_node = a.packed;
  int32_t* task_kind = a.packed + T;
  int32_t* task_seq = a.packed + 2 * T;
  int32_t* ready = a.packed + 3 * T;
  const int round = a.ctl[0];

  for (int i = tid; i < Fp2; i += nthr) {
    if (i < F) {
      const uint8_t fl = a.p_flags[i] & (PF_VALID | PF_IDLE | PF_PIPE);
      a.p_flags[i] = fl;
      const unsigned long long kn = (fl & PF_IDLE) ? (unsigned)a.p_node[i] : (unsigned)N;
      s_key[i] = (kn << 32) | (unsigned)i;
    } else {
      s_key[i] = ~0ull;
    }
  }
  __syncthreads();
  for (int k = 2; k <= Fp2; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = tid; i < Fp2; i += nthr) {
        const int ixj = i ^ jj;
        if (ixj > i) {
          const unsigned long long x = s_key[i], y = s_key[ixj];
          const bool up = (i & k) == 0;
          if (up ? x > y : x < y) {
            s_key[i] = y;
            s_key[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // running request sum per node segment against idle + eps and the pod cap
  for (int i = tid; i < F; i += nthr) {
    const int kn = (int)(s_key[i] >> 32);
    if (kn >= N || (i > 0 && (int)(s_key[i - 1] >> 32) == kn)) continue;
    float run[VTT_MAX_R];
    for (int r = 0; r < R; ++r) run[r] = 0.0f;
    // K5: ports and labels of every earlier proposal in this node's run
    uint32_t run_ports[VTT_PW] = {0, 0, 0, 0}, run_self[VTT_SW] = {0, 0};
    const float* nid = &a.idle[(size_t)kn * R];
    int pos = 0;
    for (int i2 = i; i2 < F && (int)(s_key[i2] >> 32) == kn; ++i2, ++pos) {
      const int f = (int)(s_key[i2] & 0xffffffffu);
      const float* rq = &a.task_req[(size_t)a.p_t[f] * R];
      bool ok = true;
      for (int r = 0; r < R; ++r) {
        run[r] = run[r] + rq[r];
        ok = ok && (run[r] < nid[r] + a.eps[r]);
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
      if (ok && a.task_count[kn] + pos < a.node_max_tasks[kn]) a.p_flags[f] |= PF_ACCEPT;
    }
  }
  __syncthreads();
  for (int f = tid; f < F; f += nthr) {
    const uint8_t fl = a.p_flags[f];
    const bool win_pipe = (fl & PF_PIPE) && a.best_pipe[a.p_node[f]] == f;
    if ((fl & PF_ACCEPT) || win_pipe) a.p_flags[f] = fl | PF_RAW;
  }
  __syncthreads();

  // wins must be an offset-prefix per job; apply job and task updates
  bool any_local = false;
  for (int m = tid; m < M; m += nthr) {
    bool ok = true;
    for (int p = 0; p < P; ++p) {
      const int f = m * P + p;
      const uint8_t fl = a.p_flags[f];
      const bool raw = (fl & PF_RAW) != 0;
      const bool w = raw && ok;
      ok = ok && raw;
      if (!w) continue;
      const bool ui = (fl & PF_ACCEPT) != 0;
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
      any_local = true;
    }
  }
  const bool any_win = vtt_block_any(any_local, &s_flag);

  // node updates: idle runs per segment; queue shares in flat order
  for (int i = tid; i < F; i += nthr) {
    const int kn = (int)(s_key[i] >> 32);
    if (kn >= N || (i > 0 && (int)(s_key[i - 1] >> 32) == kn)) continue;
    for (int i2 = i; i2 < F && (int)(s_key[i2] >> 32) == kn; ++i2) {
      const int f = (int)(s_key[i2] & 0xffffffffu);
      if (!(a.p_flags[f] & PF_USE_IDLE)) continue;
      const float* rq = &a.task_req[(size_t)a.p_t[f] * R];
      for (int r = 0; r < R; ++r) {
        a.idle[(size_t)kn * R + r] = a.idle[(size_t)kn * R + r] - rq[r];
        a.used[(size_t)kn * R + r] = a.used[(size_t)kn * R + r] + rq[r];
      }
      a.task_count[kn] += 1;
      if (PS) vtt_ps_fold(a, kn, vtt_ps_task(a, a.p_t[f]), +1);
    }
  }
  for (int q = tid; q < Q; q += nthr) {
    for (int f = 0; f < F; ++f) {
      if (!(a.p_flags[f] & PF_WIN)) continue;
      if (vtt_clampi(a.job_queue[a.p_job[f]], 0, Q - 1) != q) continue;
      const float* rq = &a.task_req[(size_t)a.p_t[f] * R];
      for (int r = 0; r < R; ++r)
        a.queue_alloc[(size_t)q * R + r] = a.queue_alloc[(size_t)q * R + r] + rq[r];
    }
  }
  __syncthreads();
  // pipeline wins: at most one per node
  for (int f = tid; f < F; f += nthr) {
    const uint8_t fl = a.p_flags[f];
    if (!(fl & PF_WIN) || (fl & PF_USE_IDLE)) continue;
    const int n = a.p_node[f];
    const float* rq = &a.task_req[(size_t)a.p_t[f] * R];
    for (int r = 0; r < R; ++r) {
      a.releasing[(size_t)n * R + r] = a.releasing[(size_t)n * R + r] - rq[r];
      a.used[(size_t)n * R + r] = a.used[(size_t)n * R + r] + rq[r];
    }
    a.task_count[n] += 1;
    // a pipe win has no ports or anti bits, but its labels count
    if (PS) vtt_ps_fold(a, n, vtt_ps_task(a, a.p_t[f]), +1);
  }
  __syncthreads();

  if (tid == 0) {
    const int n_active = a.ctl[1];
    const bool do_evict = !any_win && n_active > 0;
    if (do_evict) {
      const int v = a.ctl[3];
      a.dropped[v] = 1;
      if (a.use_gang_ready && ready[v] < a.job_min[v]) {
        // unwind the gang's session placements (its rows are contiguous)
        float qsum[VTT_MAX_R];
        for (int r = 0; r < R; ++r) qsum[r] = 0.0f;
        const int t0 = a.job_start[v], t1 = t0 + a.job_ntasks[v];
        for (int t = t0; t < t1; ++t) {
          const int kind = task_kind[t];
          if (kind <= 0 || !a.task_valid[t] || a.task_job[t] != v) continue;
          const int n = vtt_clampi(task_node[t], 0, N - 1);
          const float* rq = &a.task_req[(size_t)t * R];
          float* back = kind == 1 ? &a.idle[(size_t)n * R] : &a.releasing[(size_t)n * R];
          for (int r = 0; r < R; ++r) {
            back[r] = back[r] + rq[r];
            a.used[(size_t)n * R + r] = a.used[(size_t)n * R + r] - rq[r];
            qsum[r] = qsum[r] + rq[r];
          }
          a.task_count[n] -= 1;
          if (PS) vtt_ps_fold(a, n, vtt_ps_task(a, t), -1);
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
      }
    }
    a.ctl[2] = (any_win || do_evict) ? 1 : 0;
    a.ctl[0] = round + 1;
    a.ctl[1] = 0;
  }
}

static int vtt_check() { return (int)cudaGetLastError(); }

// the host round loop for one instantiation of the round kernels
template <bool PS>
static int vtt_batch_rounds(const VttSolveArgs& a, cudaStream_t s) {
  int Fp2 = 1;
  while (Fp2 < a.F) Fp2 <<= 1;
  const size_t propose_smem = (size_t)a.N * sizeof(float);
  const size_t accept_smem = (size_t)Fp2 * sizeof(unsigned long long);
  int err = (int)cudaFuncSetAttribute(vtt_batch_propose<PS>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)propose_smem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(vtt_batch_accept<PS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)accept_smem);
  if (err) return err;
  const int J = (int)a.J;
  int64_t wide = a.N + 1 > a.J ? a.N + 1 : a.J;
  if (a.M > wide) wide = a.M;
  const int keys_blocks = (int)((wide + 255) / 256);
  const dim3 rank_grid((J + 255) / 256, (J + VTT_RANK_CHUNK - 1) / VTT_RANK_CHUNK);

  if (PS) VTT_LAUNCH(vtt_ps_init, (int)((a.N + 255) / 256), 256, 0, s)(a);
  VTT_LAUNCH(vtt_batch_init, 1, 1, 0, s)(a);
  VTT_LAUNCH(vtt_batch_keys, keys_blocks, 256, 0, s)(a);
  if ((err = vtt_check())) return err;
  for (;;) {
    int32_t go = 0;
    err = (int)cudaMemcpyAsync(&go, a.ctl + 1, sizeof(go), cudaMemcpyDeviceToHost, s);
    if (err) return err;
    err = (int)cudaStreamSynchronize(s);
    if (err) return err;
    if (go <= 0) break;
    VTT_LAUNCH(vtt_batch_rank, rank_grid, 256, 0, s)(a);
    VTT_LAUNCH(vtt_batch_select, (J + 255) / 256, 256, 0, s)(a);
    VTT_LAUNCH(vtt_batch_propose<PS>, (int)a.M, VTT_PROPOSE_THREADS, propose_smem, s)(a);
    VTT_LAUNCH(vtt_batch_accept<PS>, 1, VTT_ACCEPT_THREADS, accept_smem, s)(a, Fp2);
    VTT_LAUNCH(vtt_batch_keys, keys_blocks, 256, 0, s)(a);
    if ((err = vtt_check())) return err;
  }
  return vtt_check();
}

extern "C" int vtt_allocate_solve_batch(const VttSolveArgs* args, void* stream) {
  const VttSolveArgs a = *args;
  if (a.R < 2 || a.R > VTT_MAX_R || a.P < 1 || a.P > VTT_MAX_P || a.K > a.P ||
      a.n_keys > 3 || a.F != a.M * a.P || a.has_volsel)
    return (int)cudaErrorInvalidValue;  // volumes take the exact solve only
  cudaStream_t s = (cudaStream_t)stream;
  return a.has_portsel ? vtt_batch_rounds<true>(a, s) : vtt_batch_rounds<false>(a, s);
}
